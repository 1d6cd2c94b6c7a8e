"""Ablation parity, odometry and mapping switches: `full_dof_odometry` and
`enable_map_update=False`, the port against the JAX package (see
tests/_torch_ablation.py for the drive).

`full_dof_odometry` solves all six DOFs in both scan-to-scan stages (the
LeGO-LOAM ablation of its two-step split). The port's 6-DOF stage solves
the 6x6 normal equations by cyclic Jacobi in float64 (`math/jacobi`). The
reference's `_gn_step` is written for three DOFs: with six it builds H and
g from the first three columns only (roll, pitch, yaw) and, through JAX's
clamped gather, writes the yaw step into tx, ty and tz as well
(`lego_loam_tpu/odometry.py:431-448`). So its ablation never solves the
translation. On this file's 4-scan drive the port's odometry differs from
the unmodified reference by up to 0.41 m and its map by 0.11 m; the
reference's odometry ends 0.45 m from the truth, the port's 0.07 m. The
tests therefore hold the port against the reference's own arithmetic
carried over six DOFs (`reference_gn_step_any_dof`, equal to the
reference's `_gn_step` bit for bit on every 3-DOF mask), patched into the
reference's odometry for its drive only: the slice's bounds then hold
(map within 4.8 mm, odometry within 2.4 mm, measured)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lego_loam_tpu.odometry as ref_odometry
from lego_loam_torch import odometry
from lego_loam_torch.convert import config_from_reference

from _torch_ablation import N_FRAMES, ODOM_TOL, assert_modes_equal, assert_parity, port_drive, reference_drive
from _torch_parity import small_ref_cfg


def reference_gn_step_any_dof(q_xyz, rel_time, n, d, w, dof_idx, cfg):
    """`lego_loam_tpu.odometry._gn_step` with H and g over all of dof_idx
    (the reference uses the first three) and the step placed per DOF."""
    o = cfg.odometry
    gx, gy, gz = n
    qx, qy, qz = q_xyz[:, 0], q_xyz[:, 1], q_xyz[:, 2]
    s_ = jnp.ones_like(rel_time)
    cols6 = (
        (qy * gz - qz * gy) * s_ * w,
        (qz * gx - qx * gz) * s_ * w,
        (qx * gy - qy * gx) * s_ * w,
        gx * s_ * w,
        gy * s_ * w,
        gz * s_ * w,
    )
    cols = [cols6[i] for i in dof_idx]
    k = len(cols)
    r = d * w
    H = jnp.stack([jnp.stack([jnp.sum(cols[a] * cols[b]) for b in range(k)]) for a in range(k)])
    g = jnp.stack([jnp.sum(cols[a] * r) for a in range(k)])
    evals, evecs = jnp.linalg.eigh(H)
    keep = (evals >= o.eigen_threshold).astype(H.dtype)
    ginv = jnp.where(evals > 1e-12, 1.0 / jnp.maximum(evals, 1e-12), 0.0)
    step = -(evecs @ ((evecs.T @ g) * ginv * keep)) * o.step_scale
    step = jnp.where(jnp.sum(w > 0) >= o.min_correspondences, step, 0.0)
    delta = jnp.zeros((6,))
    for j, i in enumerate(dof_idx):
        delta = delta.at[i].set(step[j])
    rot_n = jnp.linalg.norm(delta[:3])
    trans_n = jnp.linalg.norm(delta[3:])
    rot_cap = o.step_clamp_rot_deg * jnp.pi / 180.0
    scale = jnp.minimum(
        jnp.minimum(1.0, rot_cap / jnp.maximum(rot_n, 1e-12)),
        jnp.minimum(1.0, o.step_clamp_trans / jnp.maximum(trans_n, 1e-12)),
    )
    delta = delta * scale
    return delta, jnp.linalg.norm(delta[:3]) * 180.0 / jnp.pi, jnp.linalg.norm(delta[3:]) * 100.0


def gn_inputs(seed, n=2048):
    """Seeded (q, normals, d, w): points within 20 m, unit normals (odd
    seeds nearly horizontal, so H has eigenvalues below eigen_threshold and
    the degeneracy projection acts), 5 cm residuals, a fifth of the weights
    0."""
    rs = np.random.RandomState(seed)
    q = rs.uniform(-20, 20, (n, 3)).astype(np.float32)
    nrm = rs.randn(n, 3).astype(np.float32)
    if seed % 2:
        nrm[:, 2] *= 0.01
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    d = (rs.randn(n) * 0.05).astype(np.float32)
    w = (rs.uniform(0, 1, n) * (rs.rand(n) > 0.2)).astype(np.float32)
    return q, nrm, d, w


def both_steps(seed, dofs, ref_step):
    ref_cfg = small_ref_cfg()
    cfg = config_from_reference(ref_cfg)
    q, nrm, d, w = gn_inputs(seed)
    idx = tuple(i for i, on in enumerate(dofs) if on)
    ref = ref_step(jnp.asarray(q), jnp.zeros(len(q)), tuple(jnp.asarray(nrm[:, i]) for i in range(3)),
                   jnp.asarray(d), jnp.asarray(w), idx, ref_cfg)
    ours = odometry._gn_step(torch.from_numpy(q), tuple(torch.from_numpy(nrm[:, i].copy()) for i in range(3)),
                             torch.from_numpy(d), torch.from_numpy(w), idx, cfg)
    return [np.asarray(x) for x in ref], [x.numpy() for x in ours]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("dofs", [odometry.SURF_DOFS, odometry.CORNER_DOFS], ids=["surf", "corner"])
def test_gn_step_three_dofs_matches_reference(seed, dofs):
    """A 3-DOF step (closed-form eigh in float64) against the reference's
    `_gn_step` (float32 eigh): within 1e-5 of the step's largest entry
    (measured <= 1.6e-6); and `reference_gn_step_any_dof` is the
    reference's step bit for bit."""
    (ref, _, _), (ours, _, _) = both_steps(seed, dofs, ref_odometry._gn_step)
    (gen, _, _), _ = both_steps(seed, dofs, reference_gn_step_any_dof)
    assert np.array_equal(gen, ref)
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_gn_step_six_dofs(seed):
    """One 6-DOF step (Jacobi in float64) against the reference's step over
    six DOFs (float32 eigh of float32 sums): the twist within 1e-4 of its
    largest entry (measured <= 2.7e-5: the float32 eigenvectors of a 6x6 H
    whose eigenvalues span ~1e-1 to ~1e5), and the step norms with it."""
    (ref, ref_deg, ref_cm), (ours, deg, cm) = both_steps(seed, odometry.FULL_DOFS, reference_gn_step_any_dof)
    tol = 1e-4 * np.abs(ref).max()
    assert np.abs(ours - ref).max() <= tol
    assert abs(deg - ref_deg) <= 180.0 / np.pi * 2 * tol and abs(cm - ref_cm) <= 100.0 * 2 * tol
    assert np.abs(ours[3:]).max() > 0  # the translation is solved


@pytest.fixture(scope="module")
def full_dof():
    """The full-DOF drive: the reference with `reference_gn_step_any_dof`
    (its jit caches cleared after), then the port in both modes, the
    host-branching run recording every H its 6-DOF stages hand to
    `jacobi_eigh`."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_odometry, "_gn_step", reference_gn_step_any_dof)
        d = reference_drive("full_dof_odometry")
    jax.clear_caches()
    seen = []

    def recording(H, *args):
        seen.append(H.clone())
        return jacobi_eigh(H, *args)

    jacobi_eigh = odometry.jacobi_eigh
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(odometry, "jacobi_eigh", recording)
        runs = {False: port_drive(d, sync_free=False)}
    runs[True] = port_drive(d, sync_free=True)
    return d, runs, seen


def test_full_dof_odometry(full_dof):
    """The slice's bounds against the reference's full-DOF drive, and the
    reference's own check (tests/test_presets_ablations.py:147): the
    largest odometry position error over the drive < 1.5 m."""
    d, runs, _ = full_dof
    _, out = runs[False]
    assert_parity(d, out)
    assert np.linalg.norm(out["odom_positions"] - d.truth, axis=1).max() < 1.5


def test_full_dof_odometry_sync_free(full_dof):
    """`test_full_dof_odometry` for the sync_free step, bit-equal to the
    host-branching run."""
    d, runs, _ = full_dof
    assert_parity(d, runs[True][1])
    assert_modes_equal(runs[False][1], runs[True][1])


def test_jacobi_sweeps_on_full_dof_drive(full_dof):
    """Every H of the drive's 6-DOF stages: `jacobi_eigh`'s default 6 sweeps
    give each eigenvalue within 1e-9 relative of `torch.linalg.eigh` in
    float64, and an orthonormal basis that diagonalizes H."""
    _, _, seen = full_dof
    assert len(seen) >= 2 * (N_FRAMES - 1)  # both stages of every frame after the first
    for H in seen:
        H = H.double()
        evals, evecs = odometry.jacobi_eigh(H)
        exact = torch.linalg.eigh(H).eigenvalues
        assert ((evals - exact).abs() <= 1e-9 * exact.abs()).all(), (evals, exact)
        eye = torch.eye(6, dtype=H.dtype)
        assert torch.allclose(evecs.T @ evecs, eye, atol=1e-12, rtol=0)
        assert torch.allclose(evecs.T @ H @ evecs, torch.diag(evals), atol=1e-9 * exact.abs().max(), rtol=0)


@pytest.fixture(scope="module")
def no_map_update():
    d = reference_drive("no_map_update")
    return d, {sf: port_drive(d, sync_free=sf) for sf in (False, True)}


def test_no_map_update(no_map_update):
    """enable_map_update=False: the map pose is the odometry's, so the map
    is held to the odometry's 8 cm bound (measured 1.67e-2 m), and the
    reference's own check (tests/test_presets_ablations.py:89): map equals
    odometry within 1e-5 m."""
    d, runs = no_map_update
    _, out = runs[False]
    assert_parity(d, out, map_tol=ODOM_TOL)
    np.testing.assert_allclose(out["map_positions"], out["odom_positions"], atol=1e-5, rtol=0)


def test_no_map_update_sync_free(no_map_update):
    """`test_no_map_update` for the sync_free step, bit-equal to the
    host-branching run."""
    d, runs = no_map_update
    out = runs[True][1]
    assert_parity(d, out, map_tol=ODOM_TOL)
    np.testing.assert_allclose(out["map_positions"], out["odom_positions"], atol=1e-5, rtol=0)
    assert_modes_equal(runs[False][1], out)
