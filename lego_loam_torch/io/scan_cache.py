"""Disk cache for rendered synthetic scan sequences (the port's copy of
`tools/scan_cache.py`, in the same file format).

Host-side swept rendering of a campus course costs ~0.07 s a scan, and a
course at the same parameters renders the same scans every time, so the
rendered sequence is cached. Scans have ragged point counts and are stored
concatenated with offsets in one npz, under `$LEGO_SCAN_CACHE` (else
`lego_scan_cache` in the temporary directory). Every file name starts with
`torch_`, so a render of this package never stands in for one of the JAX
package's in a shared cache directory.
"""

from __future__ import annotations

import hashlib
import os
import tempfile

import numpy as np


def cache_dir() -> str:
    return os.environ.get("LEGO_SCAN_CACHE") or os.path.join(tempfile.gettempdir(), "lego_scan_cache")


def _key(tag, params):
    s = tag + "|" + "|".join(f"{k}={params[k]}" for k in sorted(params))
    return hashlib.sha1(s.encode()).hexdigest()[:16]


def get_or_render(tag, params, render_fn):
    """render_fn() -> list[(N_i, 3) float32]; cached by (tag, params)."""
    d = cache_dir()
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"torch_{tag}_{_key(tag, params)}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            flat, off = z["flat"], z["off"]
        return [flat[off[i] : off[i + 1]] for i in range(len(off) - 1)]
    scans = render_fn()
    flat = np.concatenate([np.asarray(s, np.float32) for s in scans], axis=0)
    off = np.zeros(len(scans) + 1, np.int64)
    np.cumsum([len(s) for s in scans], out=off[1:])
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, flat=flat, off=off)
    os.replace(tmp, path)
    return scans
