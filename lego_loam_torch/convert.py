"""Conversion between the JAX package's configs and states and the port's.

The JAX side arrives as host data: a config object, or a state whose leaves
are numpy arrays (e.g. after `jax.device_get`). Fields are read by name, so
this module needs nothing of the JAX package. The reverse direction returns
nested dicts of numpy arrays keyed like the JAX types' fields, from which
the caller rebuilds its own types. The stateful parity tests start both
packages from the same state this way.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import config as _config
from .backend import BackendState
from .eskf import EskfState, Nominal
from .imu import ImuTrack
from .ops.hashgrid import HashGrid
from .posegraph import Factors
from .types import FeatureCloud, MapState, OdometryState

_CONFIG_GROUPS = {
    "laser": _config.LaserConfig,
    "ground": _config.GroundConfig,
    "segmentation": _config.SegmentationConfig,
    "features": _config.FeatureConfig,
    "odometry": _config.OdometryConfig,
    "mapping": _config.MappingConfig,
    "eskf": _config.EskfConfig,
    "distributed": _config.DistributedConfig,
    "pipeline": _config.PipelineConfig,
}


def config_from_reference(cfg) -> _config.LegoLoamConfig:
    """The port's LegoLoamConfig with the same field values as `cfg`."""
    groups = {}
    for name, cls in _CONFIG_GROUPS.items():
        src = getattr(cfg, name)
        groups[name] = cls(**{f.name: getattr(src, f.name) for f in dataclasses.fields(cls)})
    return _config.LegoLoamConfig(**groups)


def _tensor(x, device):
    a = np.array(x)  # a writable copy: host state may be a read-only view
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(a).to(device)


def _from(cls, src, device):
    """Build dataclass `cls` from the same-named fields of `src` (an object
    or a dict), recursing into nested dataclass fields."""
    get = src.get if isinstance(src, dict) else lambda k: getattr(src, k)
    kw = {}
    for f in dataclasses.fields(cls):
        v = get(f.name)
        sub = _NESTED.get((cls, f.name))
        kw[f.name] = _from(sub, v, device) if sub else _tensor(v, device)
    return cls(**kw)


_NESTED = {
    (OdometryState, "last_corner"): FeatureCloud,
    (OdometryState, "last_surf"): FeatureCloud,
    (BackendState, "submap"): MapState,
}


def odometry_state_from_reference(state, device="cuda") -> OdometryState:
    return _from(OdometryState, state, device)


def backend_state_from_reference(state, device="cuda") -> BackendState:
    return _from(BackendState, state, device)


def map_state_from_reference(state, device="cuda") -> MapState:
    return _from(MapState, state, device)


def imu_track_from_reference(track, device="cuda") -> ImuTrack:
    """The port's `ImuTrack` from a reference track (a NamedTuple with
    numpy leaves)."""
    return _from(ImuTrack, track, device)


def factors_from_reference(factors, device="cuda") -> Factors:
    """The port's `Factors` from a reference factor set (a NamedTuple with
    numpy leaves, or any object with the same fields)."""
    return Factors(**{k: _tensor(getattr(factors, k), device) for k in Factors._fields})


def hashgrid_from_reference(grid, device="cuda") -> HashGrid:
    """The port's `HashGrid` from a reference grid (its table as numpy)."""
    return HashGrid(table=_tensor(grid.table, device), cell=float(grid.cell))


def eskf_state_from_reference(state, device="cuda") -> EskfState:
    """The port's `EskfState` from a reference filter state (NamedTuples with
    array leaves), so both packages start the filter from the same state."""
    x = Nominal(**{k: _tensor(getattr(state.x, k), device) for k in Nominal._fields})
    return EskfState(x=x, **{k: _tensor(getattr(state, k), device) for k in EskfState._fields if k != "x"})


def to_numpy(state) -> dict:
    """A port state (any of the dataclasses above, or `Factors`) as nested
    dicts of numpy arrays keyed by field name."""
    if isinstance(state, Factors):
        return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        out[f.name] = to_numpy(v) if dataclasses.is_dataclass(v) else v.detach().cpu().numpy()
    return out
