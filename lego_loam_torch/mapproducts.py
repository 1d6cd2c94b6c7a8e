"""Map products (port of `lego_loam_tpu/mapproducts.py`): the saved map,
the global map around a pose, and the reload of a saved dense map.

The keyframe store is read once per product: the resident slots (oldest
first) are gathered on the device into one float32 block and copied to the
host in one transfer; the transforms to the map frame and the voxel filters
run in numpy, as in the reference. A store in row blocks over the ranks is
gathered to every rank (`distributed.gather_rows`, so every rank calls a
product), and rank 0 alone writes the files.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .config import LegoLoamConfig
from .distributed import gather_rows, is_writer
from .io.pcd import load_pcd, save_pcd
from .math import se3
from .utils.metrics import write_pose_txt


def _host_voxel_ds(xyz: np.ndarray, leaf: float) -> np.ndarray:
    """The first point of each occupied voxel, in input order."""
    if len(xyz) == 0 or leaf <= 0:
        return xyz
    keys = np.floor(xyz / leaf).astype(np.int64)
    _, idx = np.unique(keys, axis=0, return_index=True)
    return xyz[np.sort(idx)]


def gather_keyframe_clouds(bstate, max_kf=None):
    """The resident keyframes' clouds in the map frame, with their poses.

    Returns a dict of numpy arrays: 'corner' and 'surf' (N, 3) over all
    keyframes, 'corner_per_kf' and 'surf_per_kf' lists, 'poses_R' (A, 3, 3),
    'poses_t' (A, 3) and 'times' (A,), oldest keyframe first."""
    slots = bstate.ordered_slots()
    if max_kf:
        slots = slots[-max_kf:]
    n = len(slots)
    nc, ns = bstate.kf_corner_mask.shape[1], bstate.kf_surf_mask.shape[1]
    sel = torch.from_numpy(np.ascontiguousarray(slots)).to(bstate.kf_t.device)

    def rows(x):
        return gather_rows(x, sel).reshape(n, -1).to(torch.float32)

    block = torch.cat([
        rows(bstate.kf_R), rows(bstate.kf_t), rows(bstate.kf_time),
        rows(bstate.kf_corner), rows(bstate.kf_corner_mask),
        rows(bstate.kf_surf), rows(bstate.kf_surf_mask),
    ], dim=1).cpu().numpy()
    cols = np.cumsum([0, 9, 3, 1, 3 * nc, nc, 3 * ns, ns])
    part = [block[:, a:b] for a, b in zip(cols[:-1], cols[1:])]
    # contiguous, as the reference's arrays are: numpy's matmul path (and
    # so the last bit of each product) depends on the layout
    R = np.ascontiguousarray(part[0]).reshape(n, 3, 3)
    t = np.ascontiguousarray(part[1])
    times = np.ascontiguousarray(part[2][:, 0])
    c, cm = np.ascontiguousarray(part[3]).reshape(n, nc, 3), part[4] > 0.5
    s, sm = np.ascontiguousarray(part[5]).reshape(n, ns, 3), part[6] > 0.5
    corners = [c[k][cm[k]] @ R[k].T + t[k] for k in range(n)]
    surfs = [s[k][sm[k]] @ R[k].T + t[k] for k in range(n)]
    return {
        "corner": np.concatenate(corners) if corners else np.zeros((0, 3)),
        "surf": np.concatenate(surfs) if surfs else np.zeros((0, 3)),
        "corner_per_kf": corners,
        "surf_per_kf": surfs,
        "poses_R": R,
        "poses_t": t,
        "times": times,
    }


def save_map(bstate, out_dir: str, cfg: LegoLoamConfig, dense: bool = True):
    """Write cornerMap.pcd, surfaceMap.pcd, finalCloud.pcd (the two
    voxel-filtered at corner_leaf and surf_leaf), denseCloud.pcd (unfiltered),
    trajectory.pcd (keyframe positions) and pose.txt (keyframe x y z roll
    pitch yaw t) under out_dir (rank 0 of a process group; the others
    only take part in the gather); returns out_dir."""
    g = gather_keyframe_clouds(bstate)
    if not is_writer():
        return out_dir
    os.makedirs(out_dir, exist_ok=True)
    m = cfg.mapping

    corner = _host_voxel_ds(g["corner"], m.corner_leaf)
    surf = _host_voxel_ds(g["surf"], m.surf_leaf)
    final = np.concatenate([corner, surf]) if len(corner) + len(surf) else np.zeros((0, 3))

    save_pcd(os.path.join(out_dir, "cornerMap.pcd"), corner)
    save_pcd(os.path.join(out_dir, "surfaceMap.pcd"), surf)
    save_pcd(os.path.join(out_dir, "finalCloud.pcd"), final)
    if dense:
        both = len(g["corner"]) + len(g["surf"])
        save_pcd(os.path.join(out_dir, "denseCloud.pcd"),
                 np.concatenate([g["corner"], g["surf"]]) if both else np.zeros((0, 3)))
    save_pcd(os.path.join(out_dir, "trajectory.pcd"), g["poses_t"])

    if len(g["poses_R"]):
        rpys = torch.stack(se3.matrix_to_euler_zyx(torch.from_numpy(g["poses_R"])), dim=-1).numpy()
    else:
        rpys = np.zeros((0, 3))
    write_pose_txt(os.path.join(out_dir, "pose.txt"), g["poses_t"], rpys, g["times"])
    return out_dir


def global_map(bstate, center, radius: float, cfg: LegoLoamConfig):
    """The clouds of the keyframes within `radius` of `center`, concatenated
    and voxel-filtered at global_leaf."""
    g = gather_keyframe_clouds(bstate)
    if len(g["poses_t"]) == 0:
        return np.zeros((0, 3))
    keep = np.linalg.norm(g["poses_t"] - np.asarray(center)[None, :], axis=1) < radius
    sel = [c for k in range(len(keep)) if keep[k] for c in (g["corner_per_kf"][k], g["surf_per_kf"][k])]
    cloud = np.concatenate(sel) if sel else np.zeros((0, 3))
    return _host_voxel_ds(cloud, cfg.mapping.global_leaf)


def load_high_dense_map(pcd_path: str, rotate: bool = False):
    """Load a saved dense map for re-localization: (xyz, intensity or None).
    rotate applies Rz(90 deg) Rx(90 deg), which undoes the LOAM camera-axis
    convention of the original system's maps; maps saved here are already
    in the lidar frame."""
    xyz, inten = load_pcd(pcd_path)
    if rotate:
        Rz = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
        Rx = np.array([[1.0, 0, 0], [0, 0, -1], [0, 1, 0]])
        xyz = xyz @ (Rz @ Rx).T
    return xyz, inten
