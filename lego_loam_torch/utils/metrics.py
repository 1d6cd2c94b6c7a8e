"""Trajectory metrics and the run's artifact writers (a numpy copy of
`lego_loam_tpu/utils/metrics.py`, which the port cannot import without jax).

The reference's de-facto regression artifacts are the `Result/<experiment>/`
files (`mapOptmization.cpp:344-434`): `pose.txt` (x, y, z, roll, pitch, yaw,
t per keyframe), `mapt.txt` (per-frame mapping runtime), `MapIterTimes.txt`
(per-frame LM iterations), and `LocalInfo.pcd` (iterations, min eigenvalue,
mean cost, frame index). This module reproduces those formats plus standard
ATE/RPE computation against ground truth.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def ate_rmse(est_t: np.ndarray, gt_t: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE after optional SE(3) (Umeyama) align."""
    est = np.asarray(est_t, np.float64)
    gt = np.asarray(gt_t, np.float64)
    assert est.shape == gt.shape
    if align and len(est) >= 3:
        mu_e = est.mean(axis=0)
        mu_g = gt.mean(axis=0)
        E = est - mu_e
        G = gt - mu_g
        H = E.T @ G
        U, _, Vt = np.linalg.svd(H)
        d = np.sign(np.linalg.det(Vt.T @ U.T))
        D = np.diag([1.0, 1.0, d])
        R = Vt.T @ D @ U.T
        est = E @ R.T + mu_g
        gt = G + mu_g
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))


def rpe_rmse(est_t: np.ndarray, gt_t: np.ndarray, delta: int = 1) -> float:
    """Relative pose (translation) error RMSE over `delta`-frame steps."""
    de = est_t[delta:] - est_t[:-delta]
    dg = gt_t[delta:] - gt_t[:-delta]
    return float(np.sqrt(np.mean(np.sum((de - dg) ** 2, axis=1))))


def write_pose_txt(path, positions, rpys, times):
    """≙ savePose (mapOptmization.cpp:399-411): x y z roll pitch yaw t."""
    with open(path, "w") as f:
        for p, e, t in zip(positions, rpys, times):
            f.write(
                f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                f"{e[0]:.6f} {e[1]:.6f} {e[2]:.6f} {t:.6f}\n"
            )


def write_mapt_txt(path, runtimes_ms: Sequence[float]):
    """≙ the mapt.txt per-frame mapping runtime log."""
    with open(path, "w") as f:
        for v in runtimes_ms:
            f.write(f"{v:.6f}\n")


def write_map_iter_times(path, iters: Sequence[int]):
    with open(path, "w") as f:
        for v in iters:
            f.write(f"{int(v)}\n")


def write_local_info(path, records):
    """≙ LocalInfo.pcd content (iter_num, min_lambda, CF_mean, frame_idx),
    written as a plain text table (one row per frame)."""
    with open(path, "w") as f:
        f.write("# iter_num min_lambda cf_mean frame_idx\n")
        for r in records:
            f.write(
                f"{int(r['iterations'])} {r['min_lambda']:.6f} "
                f"{r['cf_mean']:.6f} {int(r['frame'])}\n"
            )


def save_run_artifacts(out_dir, trajectory, diagnostics):
    """Write the full reference-parity artifact set for a run."""
    os.makedirs(out_dir, exist_ok=True)
    write_pose_txt(
        os.path.join(out_dir, "pose.txt"),
        trajectory["positions"],
        trajectory["rpys"],
        trajectory["times"],
    )
    write_mapt_txt(os.path.join(out_dir, "mapt.txt"), diagnostics["mapping_ms"])
    write_map_iter_times(
        os.path.join(out_dir, "MapIterTimes.txt"), diagnostics["iterations"]
    )
    write_local_info(os.path.join(out_dir, "LocalInfo.txt"), diagnostics["records"])
