"""The port's product surface against the reference's: trajectory metrics,
the run artifact writers, PCD files and the map products.

The writers, the PCD codec and the map products run the same numpy code on
the same float32 values, so their files are compared byte for byte; only
pose.txt's roll/pitch/yaw come from each package's own atan2 (float32,
last-bit rounding) and are compared as numbers within 1e-6 rad. The map
products read a keyframe store held by the reference (tests/_torch_parity.py's
rendered 40-keyframe circle) and converted with
`backend_state_from_reference`."""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lego_loam_tpu.backend import init_backend_state as ref_init_backend_state
from lego_loam_tpu.io import pcd as RPCD
from lego_loam_tpu import mapproducts as RMP
from lego_loam_tpu.utils import metrics as RMET
from lego_loam_torch import mapproducts as PMP
from lego_loam_torch.convert import backend_state_from_reference
from lego_loam_torch.io import pcd as PPCD
from lego_loam_torch.utils import metrics as PMET

from _torch_parity import loop_ref_cfg, loop_store, pair


def _trajectories(seed=0, n=60):
    rs = np.random.RandomState(seed)
    gt = np.cumsum(rs.randn(n, 3), axis=0)
    est = gt @ np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]]).T + [3.0, -2.0, 0.5] + rs.randn(n, 3) * 0.05
    return est.astype(np.float32), gt


@pytest.mark.parametrize("align", [True, False])
def test_ate_rmse(align):
    est, gt = _trajectories()
    a, b = RMET.ate_rmse(est, gt, align=align), PMET.ate_rmse(est, gt, align=align)
    assert a == b
    if align:  # a rigid motion plus 5 cm of noise
        assert b < 0.1


@pytest.mark.parametrize("delta", [1, 10])
def test_rpe_rmse(delta):
    est, gt = _trajectories(1)
    assert RMET.rpe_rmse(est, gt, delta=delta) == PMET.rpe_rmse(est, gt, delta=delta)


def _run_record(n=12, seed=2):
    rs = np.random.RandomState(seed)
    trajectory = {
        "positions": list(rs.randn(n, 3).astype(np.float32)),
        "rpys": list((rs.randn(n, 3) * 0.1).astype(np.float32)),
        "times": [float(np.float32(i * 0.1)) for i in range(n)],
    }
    diagnostics = {
        "mapping_ms": list(rs.uniform(5, 50, n)),
        "iterations": [int(v) for v in rs.randint(1, 20, n)],
        "records": [
            {"iterations": int(rs.randint(1, 20)), "min_lambda": float(rs.rand()), "cf_mean": float(rs.rand()),
             "rejected": False, "n_submap_corner": 10, "n_submap_surf": 20, "n_sel": 30, "frame": k}
            for k in range(n)
        ],
    }
    return trajectory, diagnostics


def test_writers_and_run_artifacts(tmp_path):
    """pose.txt, mapt.txt, MapIterTimes.txt and LocalInfo.txt byte for
    byte, through each writer and through save_run_artifacts."""
    trajectory, diagnostics = _run_record()
    for pkg, d in ((RMET, tmp_path / "ref"), (PMET, tmp_path / "ours")):
        pkg.save_run_artifacts(str(d), trajectory, diagnostics)
        pkg.write_pose_txt(str(d / "pose_only.txt"), trajectory["positions"], trajectory["rpys"], trajectory["times"])
        pkg.write_mapt_txt(str(d / "mapt_only.txt"), diagnostics["mapping_ms"])
        pkg.write_map_iter_times(str(d / "iters_only.txt"), diagnostics["iterations"])
        pkg.write_local_info(str(d / "info_only.txt"), diagnostics["records"])
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "ours")) and len(names) == 8
    for f in names:
        assert filecmp.cmp(tmp_path / "ref" / f, tmp_path / "ours" / f, shallow=False), f
    assert len((tmp_path / "ours" / "pose.txt").read_text().splitlines()) == 12


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("with_intensity", [True, False])
def test_pcd(tmp_path, binary, with_intensity):
    rs = np.random.RandomState(3)
    xyz = (rs.randn(500, 3) * 30).astype(np.float32)
    inten = rs.rand(500).astype(np.float32) if with_intensity else None
    RPCD.save_pcd(str(tmp_path / "ref.pcd"), xyz, inten, binary=binary)
    PPCD.save_pcd(str(tmp_path / "ours.pcd"), xyz, inten, binary=binary)
    assert filecmp.cmp(tmp_path / "ref.pcd", tmp_path / "ours.pcd", shallow=False)
    back, bi = PPCD.load_pcd(str(tmp_path / "ours.pcd"))
    rback, rbi = RPCD.load_pcd(str(tmp_path / "ours.pcd"))
    np.testing.assert_array_equal(back, rback)
    if binary:
        np.testing.assert_array_equal(back, xyz)
    else:  # six decimals
        np.testing.assert_allclose(back, xyz, atol=1e-6 * 200)
    assert (bi is None) == (not with_intensity)
    if with_intensity:
        np.testing.assert_array_equal(bi, rbi)


@pytest.fixture(scope="module", params=[40, 70], ids=["resident", "wrapped"])
def stores(request):
    """The reference's backend state holding the rendered circle store
    (64 slots) and its conversion to the port. 'wrapped' claims 70
    keyframes appended, so the ring's oldest resident slot is 6 and the
    keyframes are read across the wrap."""
    ref_cfg, cfg = pair(loop_ref_cfg(max_keyframes=64))
    st, _ = loop_store(cfg)
    st["n_kf"] = np.int32(request.param)
    ref = ref_init_backend_state(ref_cfg).replace(**{k: jnp.asarray(v) for k, v in st.items()})
    ours = backend_state_from_reference(jax.device_get(ref), "cpu")
    return ref_cfg, cfg, ref, ours


def test_gather_keyframe_clouds(stores):
    ref_cfg, cfg, ref, ours = stores
    a, b = RMP.gather_keyframe_clouds(ref), PMP.gather_keyframe_clouds(ours)
    assert sorted(a) == sorted(b)
    for k in ("corner", "surf", "poses_R", "poses_t", "times"):
        np.testing.assert_array_equal(b[k], np.asarray(a[k]), err_msg=k)
    assert len(b["corner_per_kf"]) == len(b["poses_t"]) == min(int(ours.n_kf), 64)
    tail = PMP.gather_keyframe_clouds(ours, max_kf=5)
    np.testing.assert_array_equal(tail["poses_t"], b["poses_t"][-5:])


def test_save_map(stores, tmp_path):
    """The six files of the saved map: five PCDs byte for byte, pose.txt
    with the same positions and times and attitudes within 1e-6 rad; the
    dense cloud reloads through load_high_dense_map."""
    ref_cfg, cfg, ref, ours = stores
    RMP.save_map(ref, str(tmp_path / "ref"), ref_cfg)
    out = PMP.save_map(ours, str(tmp_path / "ours"), cfg)
    assert out == str(tmp_path / "ours")
    for f in ("cornerMap.pcd", "surfaceMap.pcd", "finalCloud.pcd", "denseCloud.pcd", "trajectory.pcd"):
        assert filecmp.cmp(tmp_path / "ref" / f, tmp_path / "ours" / f, shallow=False), f
    a = np.loadtxt(tmp_path / "ref" / "pose.txt")
    b = np.loadtxt(tmp_path / "ours" / "pose.txt")
    assert a.shape == b.shape and len(b) > 0
    np.testing.assert_array_equal(b[:, [0, 1, 2, 6]], a[:, [0, 1, 2, 6]])
    np.testing.assert_allclose(b[:, 3:6], a[:, 3:6], atol=1e-6 + 1e-9, rtol=0)
    for rotate in (False, True):
        xyz, inten = PMP.load_high_dense_map(str(tmp_path / "ours" / "denseCloud.pcd"), rotate=rotate)
        rxyz, _ = RMP.load_high_dense_map(str(tmp_path / "ours" / "denseCloud.pcd"), rotate=rotate)
        np.testing.assert_array_equal(xyz, rxyz)
        assert inten is None and len(xyz) > 1000


@pytest.mark.parametrize("radius", [3.0, 100.0])
def test_global_map(stores, radius):
    """The keyframes within `radius` of a pose on the circle, voxel-filtered
    at global_leaf: the same points in the same order."""
    ref_cfg, cfg, ref, ours = stores
    center = np.asarray(ours.kf_t[10].numpy())
    a = RMP.global_map(ref, center, radius, ref_cfg)
    b = PMP.global_map(ours, center, radius, cfg)
    np.testing.assert_array_equal(b, np.asarray(a))
    assert len(b) > 100
