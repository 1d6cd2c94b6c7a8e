"""Branches decided on the host or on the device.

The frame step takes its data-dependent branches in one of two ways. With a
host `bool` as predicate (`sync_free=False`), the code reads the predicate
back and runs one branch, as a Python `if` does. With a device bool tensor
(`sync_free=True`), it runs both branches and selects their results leaf by
leaf with `torch.where`, the reference's `lax.cond`: no host read, so the
step can be queued ahead of the device and captured as a CUDA graph. A
selection is exact: the chosen branch's bits pass through, and a NaN or inf
of the other branch never reaches the result (selection is never a product
with 0).
"""

from __future__ import annotations

import dataclasses

import torch

from .distributed import RowBlock


def tree_where(pred, a, b):
    """`torch.where(pred, a, b)` over matching trees (tensors, tuples,
    NamedTuples, dataclasses, row blocks); equal leaves pass through."""
    if a is b:
        return a
    if isinstance(a, torch.Tensor):
        return torch.where(pred, a, b)
    if isinstance(a, RowBlock):
        return RowBlock(torch.where(pred, a.local, b.local), a.mesh, a.rows)
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{
            f.name: tree_where(pred, getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a)
        })
    if isinstance(a, tuple):
        out = [tree_where(pred, x, y) for x, y in zip(a, b)]
        return type(a)(*out) if hasattr(a, "_fields") else tuple(out)
    raise TypeError(f"tree_where: unsupported leaf {type(a).__name__}")


def cond(pred, true_fn, false_fn):
    """`true_fn()` if pred else `false_fn()`: a host bool runs one branch, a
    device bool tensor runs both and selects (`tree_where`)."""
    if isinstance(pred, torch.Tensor):
        return tree_where(pred, true_fn(), false_fn())
    return true_fn() if pred else false_fn()
