"""What decides `correct`: the port's outputs against the plain reference
(`reference/lego`, a frozen copy of the port as the CPU runs it, with the
plain twins of both kernels), on the same inputs.

The reference follows the port one frame at a time from the port's own
state: before the front step of each frame drawn for the check, the
benchmark clones the port's odometry and back-end state (`snapshot`);
after the window it loads each clone into the reference pipeline and runs
that frame's scan again, with the same seed (so the same RANSAC draws).
One frame, because the two part over many: a near-tie that K2 and its
twin break apart moves the odometry by micrometres, and the odometry
turns that into millimetres over the following frames. From each frame's
gaps (`frame_gaps`), the numbers (`readings_of`; each cell's
`limits/<cell>.json` names those it holds):

- map_pos_gap_*_m, map_rot_gap_*_deg: map position and attitude
  (scan-to-map with K2, on top of all below it);
- odom_pos_gap_*_m: odometry position (scan-to-scan with K2);
- kf_cloud_diff_*_pct: the share of the new keyframe's stored points on
  one side only or more than 1 mm apart (the front end with K1's labels:
  segmentation, features, deskew, downsampling);

each as the median, the 80th and 90th percentiles and the largest over
the checked frames (`STATS`). The 80th percentile is past a frame or two
moved by a near-tie, and within a fault that strikes a quarter of the
frames.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

CLOUD_TOL_M = 1e-3


def leaves(state, prefix: str = "") -> list:
    """(dotted name, tensor) of every leaf of a dataclass state."""
    out = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        out.extend(leaves(v, f"{prefix}{f.name}.") if dataclasses.is_dataclass(v) else [(prefix + f.name, v)])
    return out


STORE_CLOUDS = ("kf_corner", "kf_corner_mask", "kf_surf", "kf_surf_mask")


def snapshot(pipe, frame_idx: int) -> dict:
    """Device clones of the port's odometry and back-end state, queued
    behind the work already dispatched (no wait), and the index of the
    frame it runs next. The keyframe clouds (the store's bulk) are not
    cloned: a keyframe's row is written once, when it is appended, so
    `load` takes them from the final store."""
    return {"f": {k: v.clone() for k, v in leaves(pipe.fstate)},
            "b": {k: v.clone() for k, v in leaves(pipe.bstate) if k not in STORE_CLOUDS},
            "frame_idx": frame_idx}


def load(ref, snap: dict, clouds: dict):
    """Write a snapshot into the reference pipeline's state, in place: the
    keyframe clouds from `clouds` (the port's final store), with the rows
    of keyframes appended after the snapshot cleared, as they were then."""
    for part, state in (("f", ref.fstate), ("b", ref.bstate)):
        for name, leaf in leaves(state):
            if part == "b" and name in STORE_CLOUDS:
                continue
            leaf.copy_(snap[part][name])
    bs = ref.bstate
    n_kf, K = int(snap["b"]["n_kf"]), bs.capacity
    if n_kf > K:
        raise ValueError(f"the store wrapped ({n_kf} keyframes in {K} slots): its old rows are gone")
    for name in STORE_CLOUDS:
        leaf = getattr(bs, name)
        leaf.copy_(clouds[name])
        leaf[n_kf:] = 0
    ref.frame_idx = snap["frame_idx"]


def reference_pipeline(cfg_ref, seed: int, device):
    from .reference.lego.pipeline import LegoLoamPipeline as RefPipeline

    return RefPipeline(cfg_ref, seed=seed, device=device)


def ref_frames(ref) -> dict:
    """The reference's per-frame logs as host arrays, as the port's
    `finalize` reads its own: map attitude, map and odometry positions of
    every frame it ran."""
    from .reference.lego.math import se3

    log = ref._log
    rpy = torch.stack(se3.matrix_to_euler_zyx(torch.stack(log["map_R"])), dim=-1)
    return {"map_rpy": rpy.double().cpu().numpy(),
            "map_t": torch.stack(log["map_t"]).double().cpu().numpy(),
            "odom_t": torch.stack(log["odom_t"]).double().cpu().numpy()}


def euler_zyx_matrix(rpy: np.ndarray) -> np.ndarray:
    """(N, 3) roll, pitch, yaw -> (N, 3, 3) Rz(yaw) Ry(pitch) Rx(roll)."""
    r, p, y = (rpy[:, i] for i in range(3))
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    return np.stack([np.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
                     np.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
                     np.stack([-sp, cp * sr, cp * cr], -1)], -2)


def rot_gaps_deg(rpy_a: np.ndarray, rpy_b: np.ndarray) -> np.ndarray:
    """Angle (degrees) between the attitudes a_i and b_i, for each i."""
    d = np.linalg.norm(euler_zyx_matrix(rpy_a) - euler_zyx_matrix(rpy_b), axis=(1, 2))  # 2 sqrt(2) sin(angle / 2)
    return np.degrees(2.0 * np.arcsin(np.clip(d / (2.0 * np.sqrt(2.0)), 0.0, 1.0)))


def kf_rows(clouds: dict, slots) -> dict:
    """The keyframe clouds' rows at `slots` (device clones)."""
    idx = torch.as_tensor(np.asarray(slots, np.int64), dtype=torch.long, device=clouds["kf_corner"].device)
    return {k: clouds[k].index_select(0, idx).clone() for k in STORE_CLOUDS}


def cloud_diff_pcts(a: dict, b: dict) -> np.ndarray:
    """For each keyframe, the share (%) of its stored points (either
    side's mask) on one side only or more than CLOUD_TOL_M apart, the
    larger of its two clouds'."""
    shares = []
    for cloud in ("kf_corner", "kf_surf"):
        pa, pb = a[cloud].double().cpu(), b[cloud].double().cpu()
        ma, mb = a[f"{cloud}_mask"].cpu(), b[f"{cloud}_mask"].cpu()
        n = ma.shape[1]
        d = (pa.view(-1, n, 3) - pb.view(-1, n, 3)).norm(dim=-1)
        either = ma | mb
        differ = (ma != mb) | ((d > CLOUD_TOL_M) & either)
        shares.append(100.0 * differ.sum(1).double() / either.sum(1).clamp(min=1).double())
    return torch.maximum(*shares).numpy()


def frame_gaps(port: dict, ref: dict, port_rows: dict, ref_rows: dict) -> dict:
    """Per-frame gaps of a run of frames: map position (m), map attitude
    (degrees) and odometry position (m) of each frame, and the cloud share
    (%) of each keyframe they appended. port/ref: per-frame
    "map_rpy", "map_t", "odom_t" (the same frames); rows: those keyframes.
    Frames the port did not finish, or ran otherwise, read as infinite
    gaps."""
    if len(port["map_t"]) != len(ref["map_t"]) or not np.isfinite(port["map_t"]).all() \
            or not np.isfinite(port["odom_t"]).all():
        return {k: [math.inf] for k in ("map", "rot", "odom", "cloud")}
    n = min(len(port_rows["kf_corner"]), len(ref_rows["kf_corner"]))
    cloud = cloud_diff_pcts({k: v[:n] for k, v in port_rows.items()}, {k: v[:n] for k, v in ref_rows.items()})
    if len(port_rows["kf_corner"]) != len(ref_rows["kf_corner"]):
        cloud = np.append(cloud, 100.0)
    return {"map": np.linalg.norm(port["map_t"] - ref["map_t"], axis=1).tolist(),
            "rot": rot_gaps_deg(port["map_rpy"], ref["map_rpy"]).tolist(),
            "odom": np.linalg.norm(port["odom_t"] - ref["odom_t"], axis=1).tolist(),
            "cloud": cloud.tolist()}


STATS = (("median", 0.5), ("p80", 0.8), ("p90", 0.9), ("max", 1.0))
NUMBERS = (("map", "map_pos_gap", "m"), ("rot", "map_rot_gap", "deg"), ("odom", "odom_pos_gap", "m"),
           ("cloud", "kf_cloud_diff", "pct"))


def readings_of(gaps: dict) -> dict:
    """The numbers from the per-frame gaps of a whole check: for each kind
    of gap, its median, 80th and 90th percentiles (numpy's linear
    interpolation) and largest over the checked frames, as
    "<kind>_<stat>_<unit>"."""
    out = {}
    for key, name, unit in NUMBERS:
        v = np.asarray(gaps.get(key, []), np.float64)
        if len(v) == 0:
            continue
        for stat, q in STATS:
            out[f"{name}_{stat}_{unit}"] = math.inf if not np.isfinite(v).all() else float(np.quantile(v, q))
    return out


@contextlib.contextmanager
def tf32():
    """Float32 matrix products in TF32 inside the block: the control's
    precision, the next one below the configuration's float32 with TF32
    off."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def port_log(pipe) -> dict:
    """Every frame's outputs of a finalized port pipeline, by frame index:
    map attitude (roll, pitch, yaw), map and odometry positions."""
    return {"map_rpy": np.asarray(pipe.trajectory["rpys"], np.float64),
            "map_t": np.asarray(pipe.trajectory["positions"], np.float64),
            "odom_t": np.asarray(pipe.odom_positions, np.float64)}


def _reference(ref, snap: dict, clouds: dict, scans: list, run_frames):
    """The reference pipeline `ref` loaded with a snapshot and run over
    `scans`: its per-frame outputs and the keyframe rows it appended."""
    load(ref, snap, clouds)
    ref._log = {k: [] for k in ref._log}
    n_kf0 = int(snap["b"]["n_kf"])
    run_frames(ref, scans)
    out = ref_frames(ref)
    rows = kf_rows({k: getattr(ref.bstate, k) for k in STORE_CLOUDS}, range(n_kf0, int(ref.bstate.n_kf)))
    return out, rows


def follow(r, snaps: dict, clouds: dict, port: dict, scans_of, run_frames) -> tuple:
    """The reference from each snapshot over the frames that followed it in
    the port (scans_of(key) gives them, run_frames(ref, scans) runs them as
    the port did), against the port's outputs of those frames (`port_log`)
    and the keyframe rows they appended (from the final store's
    `clouds`). Returns the readings (`readings_of`) and, with `r.control`,
    the TF32 control's: the reference in TF32 in the port's place, judged
    by the reference (else None)."""
    ref = reference_pipeline(r.cfg_ref, r.pipe_seed, r.device)
    sound, control = {}, {}
    for key, snap in snaps.items():
        f0, n_kf0 = snap["frame_idx"], int(snap["b"]["n_kf"])
        scans = scans_of(key)
        out, rows = _reference(ref, snap, clouds, scans, run_frames)
        mine = {k: v[f0: f0 + len(scans)] for k, v in port.items()}
        mine_rows = kf_rows(clouds, range(n_kf0, n_kf0 + len(rows["kf_corner"])))
        for k, v in frame_gaps(mine, out, mine_rows, rows).items():
            sound.setdefault(k, []).extend(v)
        if r.control:
            with tf32():
                c_out, c_rows = _reference(ref, snap, clouds, scans, run_frames)
            for k, v in frame_gaps(c_out, out, c_rows, rows).items():
                control.setdefault(k, []).extend(v)
    del ref
    r.free()
    return readings_of(sound), readings_of(control) if r.control else None


def judged(readings: dict, lim: dict) -> list:
    """[{name, value, limit}] in the limits file's order; a number with no
    reading this run (nothing of its kind in the window) is left out, a
    reading above its limit or not finite fails."""
    return [{"name": k, "value": readings[k], "limit": lim[k]} for k in lim if k in readings]


def passed(checks: list) -> bool:
    return bool(checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks)
