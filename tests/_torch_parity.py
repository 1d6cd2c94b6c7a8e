"""Shared helpers of the parity tests between `lego_loam_tpu` (JAX, the
reference) and `lego_loam_torch` (the port): reference configs held small
for the CPU, scenes from a seed, and conversion of reference values to CPU
tensors."""

from __future__ import annotations

import dataclasses
import typing

import jax
import numpy as np
import torch

from lego_loam_tpu.config import vlp16 as ref_vlp16
from lego_loam_torch.convert import config_from_reference
from lego_loam_torch.io.synthetic import render_scan, straight_trajectory

# Serial CPU arithmetic in every parity test. With more than one intra-op
# thread, torch splits large float reductions across its threads, so the
# last bits of the port's results depend on the thread count: over the six
# frames of tests/test_torch_pipeline.py the map poses move by 9.2e-5,
# 1.07e-4 and 8.3e-4 m at 2, 4 and 8 threads from their 1-thread values
# (tests/probe_torch_threads.py). A last-bit difference can flip a
# discrete choice (a flat-feature tie, a correspondence gate), and the
# parity tests' tightest checks sit near such choices. One thread makes
# the numbers the same on every machine and under any number of test
# workers.
torch.set_num_threads(1)


def small_ref_cfg(max_keyframes=32):
    """The reference's VLP-16 preset with CPU-sized submap and keyframe caps
    and single-device semantics."""
    cfg = ref_vlp16()
    return dataclasses.replace(
        cfg,
        mapping=dataclasses.replace(
            cfg.mapping, max_keyframes=max_keyframes, max_submap_corner=4096,
            max_submap_surf=8192,
        ),
        distributed=dataclasses.replace(
            cfg.distributed, shard_backend=False, use_sharded_posegraph=False
        ),
    )


def pair(ref_cfg=None):
    """(reference config, the port's config with the same values)."""
    ref_cfg = ref_cfg or ref_vlp16()
    return ref_cfg, config_from_reference(ref_cfg)


def scene(seed, cfg, noise=0.005):
    """One noisy scan from a pose a few frames along a gently turning drive."""
    R, t = straight_trajectory(seed + 1, speed=0.2, yaw_rate=0.02)[-1]
    return render_scan(R, t, cfg, noise=noise, seed=seed)


def t(x):
    """A reference array (or numpy) as a CPU tensor."""
    return torch.from_numpy(np.array(jax.device_get(x)))


def port(obj, cls):
    """A reference pytree node as the port's dataclass `cls` (same field
    names), nested dataclass fields converted recursively."""
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        sub = hints[f.name]
        kw[f.name] = port(v, sub) if dataclasses.is_dataclass(sub) else t(v)
    return cls(**kw)


def ref_scores(cfg, frame):
    """The reference's NEAR-pass RANSAC draw for `frame` (uniform under
    fold_in(PRNGKey(0), frame)) as a tensor."""
    H, W = cfg.laser.num_vertical_scans, cfg.laser.num_horizontal_scans
    key = jax.random.fold_in(jax.random.PRNGKey(0), frame)
    return t(jax.random.uniform(key, (cfg.ground.ransac_iterations, H * W)))


def as_set(xyz, mask, decimals=4):
    """Masked rows of an (N, 3) cloud, rounded and lexsorted, for comparing
    outputs whose slot order is not defined."""
    a = np.round(np.asarray(xyz)[np.asarray(mask)], decimals)
    return a[np.lexsort(a.T[::-1])]


def loop_ref_cfg(max_keyframes=64):
    """`small_ref_cfg` with loop closure on and the verification settings of
    tests/test_loopclosure_e2e.py's short circle (sparse raw-point clouds
    need its looser fitness gate), anchors every 8 keyframes and a graph
    solve at every accepted closure. The history window (5 keyframes) and
    every 4th source point keep an ICP iteration cheap on the CPU."""
    cfg = small_ref_cfg(max_keyframes)
    return dataclasses.replace(
        cfg,
        mapping=dataclasses.replace(
            cfg.mapping, enable_loop_closure=True, loop_time_gap=1.5,
            history_keyframe_search_radius=5.0, history_keyframe_search_num=4, loop_icp_src_stride=4,
            history_keyframe_fitness_score=1.5, loop_fitness_leaf_scale=40.0,
            loop_min_inlier_frac=0.5, posegraph_anchor_stride=8, loop_solve_every_accepts=1,
        ),
    )


def _rz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def loop_store(cfg, n_kf=40, drift_deg=0.25, drift_m=0.01, seed=0):
    """A keyframe store of n_kf rendered keyframes around the 5 m circle of
    tests/test_loopclosure_e2e.py (9.5 deg a keyframe, so the last ones
    revisit the first), as numpy arrays named like BackendState's fields.

    Keyframe k's pose carries injected drift: Rz(k drift_deg) and
    k drift_m along x, applied in the map frame; the odometry steps kf_rel
    are those of the drifted chain. Clouds are sensor-frame raw points:
    corners the points more than 0.3 m above the ground (at most 1024),
    surf any valid points (at most 4096), each a seeded random subset.
    Keyframe times are k * 0.1 s. Returns (store, true positions)."""
    from lego_loam_torch.backend import KF_CORNER_CAP, KF_SURF_CAP
    from lego_loam_torch.io.synthetic import circle_trajectory

    K = cfg.mapping.max_keyframes
    poses = circle_trajectory(n_kf, radius=5.0, step_deg=9.5)
    st = {
        "kf_R": np.tile(np.eye(3, dtype=np.float32), (K, 1, 1)),
        "kf_t": np.zeros((K, 3), np.float32),
        "kf_time": np.zeros(K, np.float32),
        "kf_corner": np.zeros((K, KF_CORNER_CAP * 3), np.float32),
        "kf_corner_mask": np.zeros((K, KF_CORNER_CAP), bool),
        "kf_surf": np.zeros((K, KF_SURF_CAP * 3), np.float32),
        "kf_surf_mask": np.zeros((K, KF_SURF_CAP), bool),
        "kf_rel_R": np.tile(np.eye(3, dtype=np.float32), (K, 1, 1)),
        "kf_rel_t": np.zeros((K, 3), np.float32),
        "n_kf": np.int32(n_kf),
    }
    rs = np.random.RandomState(seed)
    for k, (R, tr) in enumerate(poses):
        D = _rz(np.deg2rad(drift_deg * k))
        st["kf_R"][k] = D @ R
        st["kf_t"][k] = D @ tr + np.array([drift_m * k, 0.0, 0.0])
        st["kf_time"][k] = np.float32(k * 0.1)
        pts = render_scan(R, tr, cfg, noise=0.01, seed=100 + k)
        pts = pts[np.isfinite(pts).all(1)]
        for name, sel, cap in (("corner", pts[:, 2] > -0.3, KF_CORNER_CAP), ("surf", slice(None), KF_SURF_CAP)):
            cloud = pts[sel]
            cloud = cloud[rs.permutation(len(cloud))[:cap]]
            st[f"kf_{name}"][k, : 3 * len(cloud)] = cloud.reshape(-1)
            st[f"kf_{name}_mask"][k, : len(cloud)] = True
        if k:
            Rp, tp = st["kf_R"][k - 1], st["kf_t"][k - 1]
            st["kf_rel_R"][k] = Rp.T @ st["kf_R"][k]
            st["kf_rel_t"][k] = Rp.T @ (st["kf_t"][k] - tp)
    return st, np.stack([tr for _, tr in poses])
