"""Voxel-hash nearest neighbours (port of `lego_loam_tpu/ops/hashgrid.py`).

- build: points are binned into cubic cells; a power-of-two hash table maps
  each cell's bucket to up to `slots` point indices (a stable sort by
  bucket, the rank within the bucket, a scatter).
- query: each query gathers the candidates of its 27 neighbouring cells'
  buckets and keeps the k nearest by true distance.

No call site of either package uses it; it stands as the kd-tree's
replacement with its tests. The reference hashes in uint32, which torch
barely supports: the hash here runs in int64, masked to 32 bits after every
multiply, so the buckets, and with the stable sort the whole table, equal
the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .knn import _key

_BIG = 1e30
_P1, _P2, _P3 = 73856093, 19349669, 83492791  # classic spatial-hash primes
_M32 = 0xFFFFFFFF


class HashGrid(NamedTuple):
    table: torch.Tensor  # (n_buckets, slots) int32 point indices, -1 empty
    cell: float


def _mul32(h, c: int):
    """(h * c) mod 2^32 for 0 <= h < 2^32, with no int64 product above
    2^48."""
    return ((((h * (c >> 16)) & 0xFFFF) << 16) + h * (c & 0xFFFF)) & _M32


def _bucket_of(v, n_buckets: int):
    """Bucket of int32 cell coordinates (..., 3): a prime-multiply combine
    and a 32-bit avalanche mix, as uint32 arithmetic (a negative coordinate
    wraps as its uint32 cast does)."""
    u = v.to(torch.int64) & _M32
    h = (_mul32(u[..., 0], _P1) + _mul32(u[..., 1], _P2) + _mul32(u[..., 2], _P3)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return (h & (n_buckets - 1)).to(torch.int32)


def build_grid(points, mask, cell: float, n_buckets: int = 1 << 17, slots: int = 16) -> HashGrid:
    """points: (T, 3); mask: (T,). n_buckets must be a power of two. A
    bucket keeps its first `slots` points in index order."""
    T = points.shape[0]
    dev = points.device
    v = torch.floor(points / cell).to(torch.int32)
    b = torch.where(mask, _bucket_of(v, n_buckets), n_buckets)  # masked -> after every bucket

    order = torch.argsort(b, stable=True)
    b_s = b[order]
    new_run = torch.ones(T, dtype=torch.bool, device=dev)
    new_run[1:] = b_s[1:] != b_s[:-1]
    run_id = torch.cumsum(new_run.to(torch.int64), 0) - 1
    pos = torch.arange(T, device=dev)
    first_of_run = torch.full((T,), T, dtype=torch.int64, device=dev).scatter_reduce(0, run_id, pos, "amin")
    rank = pos - first_of_run[run_id]

    ok = (b_s < n_buckets) & (rank < slots)
    flat_slot = torch.where(ok, b_s.to(torch.int64) * slots + rank, n_buckets * slots)
    table = torch.full((n_buckets * slots + 1,), -1, dtype=torch.int32, device=dev)
    table[flat_slot] = torch.where(ok, order, -1).to(torch.int32)  # the spare last slot takes the rest
    return HashGrid(table=table[:-1].reshape(n_buckets, slots), cell=cell)


def _neighbor_offsets(device):
    r = torch.tensor([-1, 0, 1], dtype=torch.int32, device=device)
    return torch.cartesian_prod(r, r, r)  # (27, 3), the reference's meshgrid(ij) order


def query_knn(grid: HashGrid, points, p_mask, q, q_mask, k: int):
    """k nearest unmasked `points` of each query q (Q, 3) through the grid:
    (idx (Q, k) int32, -1 where none; d2 (Q, k), 1e30 there). Neighbours
    more than one cell away are not found; callers gate at a distance of at
    most the cell. Equal distances keep the earlier candidate column, as
    the reference's top_k does."""
    n_buckets, slots = grid.table.shape
    Q, T = q.shape[0], points.shape[0]
    vq = torch.floor(q / grid.cell).to(torch.int32)
    nb = vq[:, None, :] + _neighbor_offsets(q.device)[None]  # (Q, 27, 3)
    cand = grid.table[_bucket_of(nb, n_buckets).long()].reshape(Q, 27 * slots)

    safe = torch.clamp(cand, 0, T - 1).long()
    valid = (cand >= 0) & p_mask[safe]
    d2 = torch.sum((points[safe] - q[:, None, :]) ** 2, dim=-1)
    d2 = torch.where(valid & q_mask[:, None], d2, _BIG)

    col = torch.arange(d2.shape[1], device=q.device)
    col = torch.topk(_key(d2, col), k, dim=1, largest=False).indices
    idx = torch.gather(cand, 1, col)
    d = torch.gather(d2, 1, col)
    return torch.where(d < _BIG, idx, -1), d
