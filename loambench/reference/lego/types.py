"""Fixed-shape containers flowing between pipeline stages.

Frozen dataclasses of tensors standing in for the flax `struct.PyTreeNode`
types of `lego_loam_tpu/types.py`. Field names, shapes, dtypes and the
pad-and-mask layout are the same, so a port output compares slot by slot
with the JAX package's.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class _Base:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def named_leaves(state, prefix=""):
    """(dotted name, leaf) of each leaf of a dataclass tree, in
    field-declaration order with nested dataclasses expanded in place
    ("submap.corner_xyz"): the order `jax.tree.flatten` gives the
    reference's flax structs."""
    out = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        out.extend(named_leaves(v, f"{prefix}{f.name}.") if dataclasses.is_dataclass(v) else [(prefix + f.name, v)])
    return out


@dataclasses.dataclass(frozen=True)
class ScanGrid(_Base):
    """Stage-1 output: the (H, W) range-image view of one scan."""

    xyz: torch.Tensor  # (H, W, 3) point position, 0 where invalid
    range: torch.Tensor  # (H, W) range, +inf where invalid
    valid: torch.Tensor  # (H, W) bool
    ground: torch.Tensor  # (H, W) int8: -1 invalid, 0 non-ground, 1 ground
    label: torch.Tensor  # (H, W) int32: -1 invalid, 0 outlier, >0 segment id
    rel_time: torch.Tensor  # (H, W) in-scan relative time in [0, 1]


@dataclasses.dataclass(frozen=True)
class SegmentedScan(_Base):
    """Per-row compacted segmented cloud: each row's points packed to the
    front in column order."""

    xyz: torch.Tensor  # (H, W, 3)
    range: torch.Tensor  # (H, W)
    col: torch.Tensor  # (H, W) int32 original column index
    ground: torch.Tensor  # (H, W) bool
    valid: torch.Tensor  # (H, W) bool
    count: torch.Tensor  # (H,) valid points per row
    rel_time: torch.Tensor  # (H, W)
    outlier_xyz: torch.Tensor  # (No, 3) every-5th-column outlier cloud
    outlier_mask: torch.Tensor  # (No,)
    outlier_rel: torch.Tensor  # (No,)


@dataclasses.dataclass(frozen=True)
class FeatureCloud(_Base):
    """A padded feature point set with per-point ring id and relative time."""

    xyz: torch.Tensor  # (N, 3)
    ring: torch.Tensor  # (N,) int32
    rel_time: torch.Tensor  # (N,)
    mask: torch.Tensor  # (N,) bool

    @property
    def count(self):
        return self.mask.sum()


@dataclasses.dataclass(frozen=True)
class ScanFeatures(_Base):
    corner_sharp: FeatureCloud
    corner_less_sharp: FeatureCloud
    surf_flat: FeatureCloud
    surf_less_flat: FeatureCloud
    # Ground-only slice of the less-flat cloud (the odometry surf target).
    surf_ground: FeatureCloud


@dataclasses.dataclass(frozen=True)
class OdometryState(_Base):
    """Frame-to-frame odometry accumulator."""

    R_prev_cur: torch.Tensor  # (3,3) last inter-frame motion
    t_prev_cur: torch.Tensor  # (3,)
    R_world: torch.Tensor  # (3,3) accumulated odometry pose
    t_world: torch.Tensor  # (3,)
    last_corner: FeatureCloud  # previous scan's less-sharp corners (scan end)
    last_surf: FeatureCloud  # previous scan's ground surfs + shadow grid
    initialized: torch.Tensor  # () bool


@dataclasses.dataclass(frozen=True)
class MapState(_Base):
    """Assembled submap buffers for scan-to-map refinement."""

    corner_xyz: torch.Tensor  # (Nc, 3)
    corner_mask: torch.Tensor  # (Nc,)
    surf_xyz: torch.Tensor  # (Ns, 3)
    surf_mask: torch.Tensor  # (Ns,)
