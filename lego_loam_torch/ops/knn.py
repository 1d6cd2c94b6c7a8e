"""Masked brute-force nearest neighbours (port of `lego_loam_tpu/ops/knn.py`
and `lego_loam_tpu/ops/pallas_knn.py`).

`top5_l2` is the 5-NN search of both the scan-to-scan and the scan-to-map
stages. On CUDA tensors it launches kernel K2 (`csrc/knn.cu`); on CPU
tensors it takes the plain twin `top5_l2_plain`, a masked `pairwise_sqdist`
plus `topk`, chunked over the targets.
"""

from __future__ import annotations

import torch

from .. import cuda

BIG = 1e30
K = 5
_TILE = 256  # targets per tile of K2's exact path
_QB = 32  # queries per block of K2's exact path (8 warps of 4)
_GQ = 128  # queries per block of K2's grouped path (one per thread)
_MAX_SPLITS = 16
_SM_COUNT: dict = {}
_SCRATCH: dict = {}


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


def _sm_count(dev):
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SM_COUNT[dev]


def _scratch(dev, stream, n_counters, n_part):
    """K2's scratch, kept per (device, stream) so that a call allocates
    nothing but its outputs: the zeroed ticket counters, one per query block
    (the block that merges a query block's splits resets its counter), and
    room for the (S, Q, 5) split lists, d2 then index. Launches ordered on
    one stream share them. A launch captured into a CUDA graph takes its own
    (zeroed in the graph, kept by the graph's memory pool), so no eager
    launch and no other graph shares them, and none is freed under it."""
    if torch.cuda.is_current_stream_capturing():
        return (torch.zeros(max(n_counters, 1), dtype=torch.int32, device=dev),
                torch.empty(max(2 * n_part, 1), dtype=torch.int32, device=dev))
    key = (dev, stream)
    counters, part = _SCRATCH.get(key, (None, None))
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(max(n_counters, 256), dtype=torch.int32, device=dev)
    if part is None or part.numel() < 2 * n_part:
        part = torch.empty(max(2 * n_part, 1 << 16), dtype=torch.int32, device=dev)
    _SCRATCH[key] = counters, part
    return counters, part


def k2_split(Q, T, groups, tile, sm_count):
    """(split_len, S): K2 cuts the T targets into S splits of split_len (a
    multiple of the tile). The exact path aims at ~12 warps of 4 queries per
    SM, with at least 2 tiles (512 targets) a split; the grouped path at ~2
    blocks per SM. At most 16 splits."""
    n_tiles = -(-T // tile)
    if groups == 1:
        S = min(max(1, n_tiles // 2), -(-12 * sm_count // -(-Q // 4)))
    else:
        S = min(n_tiles, -(-2 * sm_count // -(-Q // _GQ)))
    S = max(1, min(S, _MAX_SPLITS))
    split_len = -(-n_tiles // S) * tile
    return split_len, -(-T // split_len)


def top5_l2(query, target, t_mask, groups=1, t_tile=2048, site=""):
    """5 nearest unmasked targets per query, sorted by squared distance:
    (idx (Q,5) int32, -1 where fewer than 5; d2 (Q,5) f32, 1e30 there).

    CUDA tensors launch K2; CPU tensors take the twin. Replaces
    `lego_loam_tpu/ops/pallas_knn.py::pallas_topk_l2` (k fixed at 5).
    groups > 1 follows the TPU kernel's residue-class approximation over
    tiles of t_tile targets (T must divide by t_tile); groups=1 is exact.
    `site` names the caller in the launch counts."""
    if query.device.type != "cuda":
        return top5_l2_plain(query, target, t_mask, groups, t_tile)
    dev = query.device
    Q, T = query.shape[0], target.shape[0]
    cuda.require(query, "query", torch.float32, dev, (Q, 3))
    cuda.require(target, "target", torch.float32, dev, (T, 3))
    cuda.require(t_mask, "t_mask", torch.bool, dev, (T,))
    groups = _effective_groups(groups, t_tile)
    tile = t_tile if groups > 1 else _TILE
    if groups > 1 and T % t_tile:
        raise ValueError(f"groups > 1 needs T % {t_tile} == 0, got T={T}")
    if Q == 0 or T == 0:
        return (torch.full((Q, K), -1, dtype=torch.int32, device=dev),
                torch.full((Q, K), BIG, dtype=torch.float32, device=dev))
    if t_mask.data_ptr() % 4:  # K2 copies the mask 4 bytes at a time
        t_mask = t_mask.clone()
    out_d = torch.empty((Q, K), dtype=torch.float32, device=dev)  # the kernel writes every slot
    out_i = torch.empty((Q, K), dtype=torch.int32, device=dev)
    split_len, S = k2_split(Q, T, groups, tile, _sm_count(dev))
    stream = cuda.stream_ptr(dev)
    n_part = S * Q * K if S > 1 else 0
    counters, part = _scratch(dev, stream, -(-Q // min(_QB, _GQ)), n_part)
    part_d = part.data_ptr()
    lib = cuda.library("knn")
    err = lib.knn_top5_launch(
        query.data_ptr(), target.data_ptr(), t_mask.data_ptr(), Q, T, tile, groups,
        split_len, S, part_d, part_d + 4 * n_part, out_d.data_ptr(),
        out_i.data_ptr(), counters.data_ptr(), stream,
    )
    cuda.check(err, "knn_top5 launch")
    cuda.count("knn_top5", site)
    return out_i, out_d
