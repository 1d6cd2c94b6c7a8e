"""Voxel-grid downsampling (port of `lego_loam_tpu/ops/voxel.py`).

Quantize to a local grid packed into one int32 key (10 bits per axis covers
+-radius at the given leaf), sort, and average the points sharing a voxel.
The sort here is stable, so the order of voxels that tie under
`radial_pack` differs from the reference's unstable sort: compare outputs
as sets.
"""

from __future__ import annotations

import torch

_OUT = 0x3FFFFFFF  # key of points outside the grid
_MASKED = 0x7FFFFFFF  # key of masked points (sorts last)


def voxel_keys(xyz, leaf: float, radius: float, origin=None):
    """Pack voxel coords into int32 keys; points outside +-radius of origin
    get the sentinel key. 10 bits per axis."""
    if origin is not None:
        xyz = xyz - origin
    n_half = int(radius / leaf)
    if n_half > 512:
        raise ValueError(f"radius/leaf = {n_half} does not fit 10 bits per axis")
    v = torch.floor(xyz / leaf).to(torch.int32) + n_half
    ok = ((v >= 0) & (v < 1024)).all(dim=-1)
    key = (v[..., 0] << 20) | (v[..., 1] << 10) | v[..., 2]
    return torch.where(ok, key, _OUT), ok


def voxel_downsample_masked(
    xyz, mask, leaf: float, radius: float, origin=None, extras=None,
    radial_pack: bool = False,
):
    """(N,3), (N,) -> (N,3), (N,): one centroid per occupied voxel, packed to
    the front.

    radial_pack: order the output by Chebyshev voxel distance from the grid
    origin instead of key order, so a caller that truncates to a capacity
    drops the farthest voxels rather than an axis-aligned slab of the scene.
    extras: optional (N,) float arrays pooled by per-voxel mean and returned,
    packed like the points, as a list after the mask."""
    N = xyz.shape[0]
    dev = xyz.device
    extras = list(extras) if extras is not None else []
    key, inb = voxel_keys(xyz, leaf, radius, origin)
    key = torch.where(mask & inb, key, _MASKED)

    key_s, order = torch.sort(key, stable=True)
    valid_s = key_s != _MASKED
    first = torch.ones(N, dtype=torch.bool, device=dev)
    first[1:] = key_s[1:] != key_s[:-1]
    first &= valid_s
    run = torch.cumsum(first.to(torch.int64), 0) - 1  # voxel id per sorted point
    n_vox = first.sum()

    vals = torch.stack([xyz[:, 0], xyz[:, 1], xyz[:, 2], *extras], dim=1)[order]
    vals = torch.where(valid_s[:, None], vals, 0.0)
    # Per-voxel sums over the sorted runs. A segmented reduction adds each
    # voxel's points in order; a float index_add_ on the GPU adds them in
    # whatever order its atomics land, and the card's runs of the same scans
    # drifted apart from the first frame on. On the CPU both give the same
    # bits. The masked tail (sorted last) takes one segment per point after
    # the voxels': the reduction loops over a segment serially.
    tail = n_vox + torch.arange(N, device=dev) - valid_s.sum()
    seg = torch.where(valid_s, run, tail)
    lengths = torch.zeros(N, dtype=torch.int64, device=dev).index_add_(0, seg, torch.ones_like(seg))
    sums = torch.segment_reduce(vals, "sum", lengths=lengths, axis=0, unsafe=True)
    cnt = torch.segment_reduce(valid_s.to(vals.dtype), "sum", lengths=lengths, axis=0, unsafe=True)
    means = sums / torch.clamp(cnt, min=1.0)[:, None]  # row v = voxel v, key order

    out_mask = torch.arange(N, device=dev) < n_vox
    if radial_pack:
        n_half = int(radius / leaf)
        # key of voxel v; masked points write their sentinel to a spare slot
        vkey = torch.full((N + 1,), _MASKED, dtype=torch.int32, device=dev)
        vkey = vkey.scatter(0, torch.where(valid_s, run, N), key_s)[:N]
        vx = (vkey >> 20) & 1023
        vy = (vkey >> 10) & 1023
        vz = vkey & 1023
        r = torch.maximum(
            torch.maximum((vx - n_half).abs(), (vy - n_half).abs()), (vz - n_half).abs()
        )
        r = torch.where(out_mask, r, _MASKED)
        means = means[torch.argsort(r, stable=True)]

    out = torch.where(out_mask[:, None], means[:, :3], 0.0)
    if extras:
        return out, out_mask, [
            torch.where(out_mask, means[:, 3 + i], 0.0) for i in range(len(extras))
        ]
    return out, out_mask
