"""Staging a chunk's inputs for the device: the scans' range images packed
on a small pool of worker threads, and the upload through pinned host
buffers on a side CUDA stream.

`pack_range_images` packs the raw clouds of a chunk in a few groups of
scans, one task a group, each task writing its scans' rows of the chunk's
arrays, so the arrays equal a serial loop's. The packing's array
operations release the interpreter lock, so the workers run beside the
thread that enqueues the frame steps.

`PinnedUploader` copies a chunk's arrays to fresh device tensors on its own
stream with `non_blocking=True`, from a set of pinned host buffers per
shape of chunk, and waits on the host for the copy: the copy overlaps the
frame steps queued on the device, and the tensors it returns are whole, to
be read from any stream. They are held for the reading stream
(`record_stream`), so that their memory is reused only after the work
queued there has read them.
"""

from __future__ import annotations

import contextlib
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .ops.projection import host_pack_range_images

# Threads packing a chunk's scans: at most 4, and one core left to the
# thread that enqueues the frame steps.
PACK_WORKERS = max(1, min(4, (os.cpu_count() or 2) - 1))
RANGE_FEED = ("rimg", "azr", "elr", "rowe")

_pool = None
_pool_lock = threading.Lock()


def _packers() -> ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(max_workers=PACK_WORKERS, thread_name_prefix="lego-pack")
    return _pool


def pack_range_images(scans, cfg, out: dict) -> dict:
    """Pack the raw clouds of a chunk ((N, 3), NaN rows = misses) into out's
    arrays (RANGE_FEED keys, scan c in row c; rimg may be wider than
    uint16): PACK_WORKERS groups of consecutive scans (one scan a group
    with VLP-32C), each group one `host_pack_range_images` call on the
    pool. Few, long numpy calls take the lock seldom, which keeps the
    packing from slowing the enqueueing thread."""
    C = len(scans)
    size = 1 if cfg.laser.use_vlp32c else max(1, -(-C // PACK_WORKERS))
    groups = [range(s, min(s + size, C)) for s in range(0, C, size)]

    def one(g):
        for k, v in zip(RANGE_FEED, host_pack_range_images([scans[c] for c in g], cfg)):
            out[k][g.start:g.stop] = v

    if len(groups) > 1:
        list(_packers().map(one, groups))
    elif groups:
        one(groups[0])
    return out


class _Buffers:
    """One set of pinned host buffers: `arrays` (numpy views) to fill,
    `host` (the tensors) to copy from."""

    def __init__(self, spec):
        self.host = {k: torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dt)).dtype, pin_memory=True)
                     for k, shape, dt in spec}
        self.arrays = {k: v.numpy() for k, v in self.host.items()}
        self.lock = threading.Lock()


class PinnedUploader:
    """Host-to-device copies of staged chunks on a side stream of `device`,
    through pinned buffers: one set for each `spec` ((name, shape, numpy
    dtype), ...), made at its first use."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self._sets: dict = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def buffers(self, spec):
        """The set of pinned buffers for spec, held by the caller until the
        block ends: fill its `arrays`, then `upload` it."""
        with self._lock:
            bufs = self._sets.get(spec)
            if bufs is None:
                bufs = self._sets[spec] = _Buffers(spec)
        with bufs.lock:
            yield bufs

    def upload(self, bufs: _Buffers, reader) -> dict:
        """Copy the set's buffers into new device tensors on the side stream
        and wait for the copy; the tensors (a dict in the spec's order) are
        held for the `reader` stream. The set is free again on return."""
        with torch.cuda.stream(self.stream):
            out = {k: torch.empty(h.shape, dtype=h.dtype, device=self.device).copy_(h, non_blocking=True)
                   for k, h in bufs.host.items()}
            done = torch.cuda.Event()
            done.record()
        done.synchronize()
        for t in out.values():
            t.record_stream(reader)
        return out
