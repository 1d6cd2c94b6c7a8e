"""The keyframe store's accessors on one device: the port's store helpers
(`lego_loam_torch/distributed.py`) for whole leaves, which is the only
layout the benchmark's cells run (one rank, no row blocks)."""

from __future__ import annotations

import torch

from .types import named_leaves


def gather_rows(leaf, idx):
    """Rows `idx` (a 1-D int tensor of slots) of the leaf, in idx order."""
    return leaf.index_select(0, idx.long())


def write_row(leaf, slot, row, where):
    """Row `slot` (a (1,) int tensor) of the leaf becomes `row` where the
    bool tensor `where` holds and keeps its value elsewhere, in place and
    decided on the device (no host read)."""
    slot = slot.long()
    leaf.index_copy_(0, slot, torch.where(where, row, leaf.index_select(0, slot)[0])[None])


def assign(dst, src):
    """dst takes src's values in place: the state's buffers keep their
    addresses."""
    if dst is not src:
        dst.copy_(src)


def assign_state(dst, src):
    """Every leaf of the state `dst` takes the matching leaf of `src` in
    place (`assign`)."""
    for (_, d), (_, s) in zip(named_leaves(dst), named_leaves(src)):
        assign(d, s)
