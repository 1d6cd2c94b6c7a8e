"""The IMU / LiDAR / Ackermann ESKF study: `lego_loam_torch.eskf` and
`ackermann` against `lego_loam_tpu.eskf` and `ackermann`.

The reference's four unit tests (tests/test_eskf.py:12-63) run on the port
with their own tolerances. Both filters start from the same state
(`convert.eskf_state_from_reference`) and run 600 ticks of a generated
stream (`io.synthetic.synth_eskf_fixture`: a straight drive and a
constant-radius turn, in the reference fixtures' JSON format, read back by
both packages' loaders): positions within 1e-3 m at every tick, the final
covariance within 1e-3 relative to its largest entry. The Ackermann
measurement and its jacfwd covariance are compared at steer 0 and at steer
!= 0: z within 1e-6, the covariance's diagonal within 1e-4 relative, all
finite. The run over the reference's own fixtures skips without them, as
tests/test_eskf.py does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu import ackermann as ref_ackermann
from lego_loam_tpu import eskf as ref_eskf
from lego_loam_tpu.io import eskf_data as ref_eskf_data
from lego_loam_torch import eskf as E
from lego_loam_torch.ackermann import ackermann_kinematics, measurement_and_covariance
from lego_loam_torch.convert import eskf_state_from_reference
from lego_loam_torch.io import eskf_data
from lego_loam_torch.io.synthetic import synth_eskf_fixture

import _torch_parity  # noqa: F401  (one torch thread)

T_PARITY = 600


def _f(x):
    return torch.tensor(x, dtype=torch.float32)


def test_propagation_static_gravity():
    """Stationary IMU measuring +g up should keep the state still."""
    p = E.EskfParams()
    s = E.init_state(np.zeros(3), np.zeros(3), np.zeros(3), device="cpu")
    acc = _f([0.0, 0.0, 9.81])
    for _ in range(10):
        s = s._replace(x=E._propagate_nominal(s.x, acc, torch.zeros(3), p.dt_imu))
    np.testing.assert_allclose(s.x.p.numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(s.x.v.numpy(), 0.0, atol=1e-6)


def test_propagation_constant_acceleration():
    p = E.EskfParams()
    x = E.init_state(np.zeros(3), np.zeros(3), np.zeros(3), device="cpu").x
    acc = _f([1.0, 0.0, 9.81])
    n = 100
    for _ in range(n):
        x = E._propagate_nominal(x, acc, torch.zeros(3), p.dt_imu)
    t = n * p.dt_imu
    np.testing.assert_allclose(x.v.numpy(), [t, 0, 0], atol=1e-4)
    np.testing.assert_allclose(x.p.numpy(), [0.5 * t * t, 0, 0], atol=1e-3)


def test_ackermann_straight_line():
    new_xy, vel_xy, heading, omega_B, enc = ackermann_kinematics(_f(10.0), _f(0.0), _f(0.0), _f(0.0), torch.zeros(2), 0.01)
    # wheel rate 10 rad/s * 0.1 m radius = 1 m/s forward
    np.testing.assert_allclose(vel_xy.numpy(), [1.0, 0.0], atol=1e-6)
    assert float(omega_B) == 0.0


def test_ackermann_turn_direction():
    _, _, _, omega_pos, _ = ackermann_kinematics(_f(10.0), _f(0.1), _f(0.0), _f(0.0), torch.zeros(2), 0.01)
    _, _, _, omega_neg, _ = ackermann_kinematics(_f(10.0), _f(-0.1), _f(0.0), _f(0.0), torch.zeros(2), 0.01)
    assert float(omega_pos) * float(omega_neg) < 0  # opposite turn directions


@pytest.mark.parametrize("vc, sc, enc, heading", [(1227.0, 0.0, 0.0, 0.1), (1227.0, 130.0, 0.02, 0.3),
                                                  (900.0, -100.0, -0.05, -1.0)])
def test_measurement_and_covariance(vc, sc, enc, heading):
    """At steer 0 the straight-line branch divides by sin(0) before `where`
    discards it; the forward-mode tangents must stay finite there."""
    z, R = measurement_and_covariance(_f(vc), _f(sc), _f(enc), _f(heading), torch.zeros(3), 0.01)
    rz, rR = ref_ackermann.measurement_and_covariance(
        jnp.float32(vc), jnp.float32(sc), jnp.float32(enc), jnp.float32(heading), jnp.zeros(3), 0.01
    )
    assert z.dtype == R.dtype == torch.float32
    assert torch.isfinite(z).all() and torch.isfinite(R).all()
    np.testing.assert_allclose(z.numpy(), np.asarray(rz), atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.diag(R.numpy()), np.diag(np.asarray(rR)), rtol=1e-4, atol=0)
    np.testing.assert_array_equal(R.numpy() - np.diag(np.diag(R.numpy())), 0.0)


@pytest.fixture(scope="module", params=[0.0, 0.05], ids=["straight", "turn"])
def stream(request, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("eskf"))
    yaw_rate = synth_eskf_fixture(d, n=T_PARITY + 1, speed=1.0, steer=request.param, seed=7)
    assert (yaw_rate != 0.0) == (request.param != 0.0)
    assert eskf_data.available(d)
    return d


def test_loaders_agree(stream):
    ours, ref = eskf_data.load(stream), ref_eskf_data.load(stream)
    assert sorted(ours) == sorted(ref)
    for k in ours:
        np.testing.assert_array_equal(ours[k], ref[k])
    np.testing.assert_array_equal(
        eskf_data.quaternion_noise_scale(ours["lidar_rpy_gt"], ours["lidar_rpy"]),
        ref_eskf_data.quaternion_noise_scale(ref["lidar_rpy_gt"], ref["lidar_rpy"]),
    )
    assert eskf_data.load_reference_output(stream + "/none.txt") is None


def test_run_eskf_matches_reference(stream):
    d = eskf_data.load(stream)
    T = T_PARITY
    qn = np.asarray(eskf_data.quaternion_noise_scale(d["lidar_rpy_gt"], d["lidar_rpy"]), np.float32)
    inputs = [np.asarray(d[k][:T] if k not in ("lidar_pos", "lidar_rpy") else d[k], np.float32)
              for k in ("acc_mea", "omega_mea", "lidar_pos", "lidar_rpy", "vel_count", "steer_count")]
    rs0 = ref_eskf.init_state(d["gt_pos"][0], d["gt_vel"][0], d["gt_att"][0])
    rs, rh = jax.jit(lambda: ref_eskf.run_eskf(*map(jnp.asarray, inputs), rs0, jnp.asarray(qn)))()
    s0 = eskf_state_from_reference(jax.device_get(rs0), "cpu")
    own = E.init_state(d["gt_pos"][0], d["gt_vel"][0], d["gt_att"][0], device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(tuple(s0)), jax.tree_util.tree_leaves(tuple(own))):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=0)  # init_state agrees with the reference's
    s, h = E.run_eskf(*inputs, s0, qn)
    assert h["pos"].shape == (T, 3) and all(torch.isfinite(v).all() for v in h.values())
    np.testing.assert_allclose(h["pos"].numpy(), np.asarray(rh["pos"]), atol=1e-3, rtol=0)
    rP = np.asarray(rs.P)
    np.testing.assert_allclose(s.P.numpy(), rP, atol=1e-3 * np.abs(rP).max(), rtol=0)
    rmse = np.sqrt(np.mean(np.sum((h["pos"].numpy() - d["gt_pos"][1:T + 1]) ** 2, axis=1)))
    assert rmse < 0.1, rmse


def test_eskf_fixture_run_tracks_ground_truth():
    """tests/test_eskf.py's fixture run on the port."""
    if not ref_eskf_data.available():
        pytest.skip("reference ESKF fixtures not mounted")
    d = eskf_data.load(ref_eskf_data.DEFAULT_DIR)
    T = 4999
    qn = eskf_data.quaternion_noise_scale(d["lidar_rpy_gt"], d["lidar_rpy"])
    s0 = E.init_state(d["gt_pos"][0], d["gt_vel"][0], d["gt_att"][0], device="cpu")
    _, hist = E.run_eskf(d["acc_mea"][:T], d["omega_mea"][:T], d["lidar_pos"], d["lidar_rpy"], d["vel_count"][:T],
                         d["steer_count"][:T], s0, qn)
    gt = d["gt_pos"][1:T + 1]
    rmse = np.sqrt(np.mean(np.sum((hist["pos"].numpy() - gt) ** 2, axis=1)))
    assert rmse < 0.1, f"ESKF RMSE vs GT {rmse:.3f} m"
