"""Masked brute-force nearest neighbours (port of `lego_loam_tpu/ops/knn.py`
and `lego_loam_tpu/ops/pallas_knn.py`).

`top5_l2` is the 5-NN search of both the scan-to-scan and the scan-to-map
stages: on every device the plain `top5_l2_plain`, a masked
`pairwise_sqdist` plus `topk`, chunked over the targets.
"""

from __future__ import annotations

import torch


BIG = 1e30
K = 5
_TILE = 256  # targets per tile of K2's exact path


def pairwise_sqdist(q, t):
    """(Q,3),(T,3) -> (Q,T) squared distances |q|^2 + |t|^2 - 2 q.t, >= 0."""
    qq = (q * q).sum(-1, keepdim=True)
    tt = (t * t).sum(-1)[None, :]
    return torch.clamp(qq + tt - 2.0 * (q @ t.T), min=0.0)


def _effective_groups(groups, tile):
    # Keep >= 128 lanes per tile after the group reduction, as the TPU
    # kernel does (clamp, don't fail).
    while groups > 1 and (tile % groups or tile // groups < 128):
        groups //= 2
    return groups


def _key(d2, pos):
    """int64 sort keys ordering candidates by (d2, pos): the bits of a
    non-negative float32 order like the float, and pos breaks ties."""
    return (d2.contiguous().view(torch.int32).to(torch.int64) << 32) | pos


def top5_l2_plain(query, target, t_mask, groups=1, t_tile=2048, chunk=16384):
    """Plain PyTorch twin of K2 -> (idx (Q,5) int32, -1 if empty; d2 (Q,5)).

    Masked `pairwise_sqdist` plus `topk`, chunked over the targets. Equal
    distances keep the earlier candidate (the target index; with groups > 1,
    the tile, then the lane), as the kernels' sorted insertion does."""
    Q, T = query.shape[0], target.shape[0]
    dev = query.device
    big = torch.full((Q, K), BIG, dtype=torch.float32, device=dev)
    best_k = _key(big, torch.tensor(2 ** 31 - 1, device=dev))
    best_i = torch.full((Q, K), -1, dtype=torch.int64, device=dev)
    groups = _effective_groups(groups, t_tile)
    if groups > 1:
        if T % t_tile:
            raise ValueError(f"groups > 1 needs T % {t_tile} == 0, got T={T}")
        chunk = t_tile * max(1, chunk // t_tile)
    for s in range(0, T, chunk):
        tc = target[s : s + chunk]
        d2 = torch.where(t_mask[None, s : s + chunk], pairwise_sqdist(query, tc), BIG)
        idx = torch.arange(s, s + tc.shape[0], device=dev).expand(Q, -1)
        if groups > 1:
            L = t_tile // groups
            n = tc.shape[0] // t_tile
            gmin, garg = d2.reshape(Q, n, groups, L).min(dim=2)  # first group wins ties
            lane = torch.arange(L, device=dev)
            base = s + torch.arange(n, device=dev)[:, None] * t_tile
            idx = (base + garg * L + lane).reshape(Q, -1)
            d2 = gmin.reshape(Q, -1)
        pos = s + torch.arange(d2.shape[1], device=dev)
        keys = torch.cat([best_k, _key(d2, pos)], dim=1)
        top = torch.topk(keys, K, dim=1, largest=False)
        best_k = top.values
        best_i = torch.gather(torch.cat([best_i, idx], dim=1), 1, top.indices)
    best_d = (best_k >> 32).to(torch.int32).view(torch.float32)
    best_i = torch.where(best_d < BIG, best_i, -1)
    return best_i.to(torch.int32), best_d


def top5_l2(query, target, t_mask, groups=1, t_tile=2048, site=""):
    """5 nearest unmasked targets per query, sorted by squared distance:
    (idx (Q,5) int32, -1 where fewer than 5; d2 (Q,5) f32, 1e30 there),
    by `top5_l2_plain` on every device. `site` is accepted and unused."""
    return top5_l2_plain(query, target, t_mask, groups, t_tile)
