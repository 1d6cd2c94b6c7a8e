#!/usr/bin/env python3
"""How many sweep-and-hook rounds the reference's plain connected-component
labeller (`lego_loam_tpu/ops/segmentation.py::converged_labels`, capped at
`segmentation.label_prop_iters`, default 10) needs on adversarial masks,
against the port's labels (K1's plain twin, run to the fixpoint).

    JAX_PLATFORMS=cpu python tests/probe_cc_rounds.py

Masks: a zigzag staircase across the scan (16, 32 and 64 rows), random
depth-first mazes (16 and 64 rows, seeds 0-2), and two or more staircase
bands joined into one path (tests/test_torch_frontend_ops.py's
`_band_snake`). Prints, per mask, its pixels, the rounds the reference
needs to reach the port's labels and the pixels 10 rounds leave
unfinished. Runs on the CPU in a few minutes.
"""

import dataclasses
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path[:0] = [os.path.join(os.path.dirname(os.path.abspath(__file__)), p) for p in ("..", ".")]

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from lego_loam_tpu.config import vlp16  # noqa: E402
from lego_loam_tpu.ops import segmentation as RS  # noqa: E402
from lego_loam_tpu.types import ScanGrid as RefScanGrid  # noqa: E402
from lego_loam_torch.convert import config_from_reference  # noqa: E402
from lego_loam_torch.ops import segmentation as PS  # noqa: E402
from lego_loam_torch.types import ScanGrid  # noqa: E402
from test_torch_frontend_ops import _band_snake, _staircase  # noqa: E402

W = 1800


def maze(h, w, seed):
    """A randomized depth-first maze: cells at even rows and odd columns,
    passages between them."""
    rs = np.random.RandomState(seed)
    c = np.zeros((h, w), bool)
    R, C = (h + 1) // 2, (w - 2) // 2
    seen = np.zeros((R, C), bool)
    stack = [(0, 0)]
    seen[0, 0] = c[0, 1] = True
    while stack:
        r, q = stack[-1]
        nb = [(r + dr, q + dq) for dr, dq in ((1, 0), (-1, 0), (0, 1), (0, -1))
              if 0 <= r + dr < R and 0 <= q + dq < C and not seen[r + dr, q + dq]]
        if not nb:
            stack.pop()
            continue
        nr, nq = nb[rs.randint(len(nb))]
        seen[nr, nq] = c[2 * nr, 2 * nq + 1] = c[r + nr, q + nq + 1] = True
        stack.append((nr, nq))
    return c


def fields(cand):
    h, w = cand.shape
    return dict(xyz=np.zeros((h, w, 3), np.float32), range=np.where(cand, 10.0, np.inf).astype(np.float32),
                valid=cand, ground=np.where(cand, 0, -1).astype(np.int8),
                label=np.zeros((h, w), np.int32), rel_time=np.zeros((h, w), np.float32))


def main():
    ref = vlp16()
    f = {}
    masks = [(f"staircase {h} rows", _staircase(h, W)) for h in (16, 32, 64)]
    masks += [(f"maze {h} rows seed {s}", maze(h, W, s)) for h in (16, 64) for s in range(3)]
    masks += [(f"band snake {h} rows", _band_snake(h, W)) for h in (16, 64)]
    for name, cand in masks:
        f = fields(cand)
        ours = PS.converged_labels(ScanGrid(**{k: torch.from_numpy(v) for k, v in f.items()}),
                                   config_from_reference(ref))[0].numpy()
        grid = RefScanGrid(**{k: jnp.asarray(v) for k, v in f.items()})

        def labels(iters):
            cfg = dataclasses.replace(ref, segmentation=dataclasses.replace(ref.segmentation, label_prop_iters=iters))
            return np.asarray(jax.jit(lambda g: RS.converged_labels(g, cfg)[0])(grid))

        need = next(k for k in range(1, 129) if (labels(k) == ours).all())
        left = int((labels(10) != ours).sum())
        print(f"{name}: {int(cand.sum())} pixels, {len(np.unique(ours[cand]))} components, "
              f"{need} rounds to the port's labels, {left} pixels unfinished after 10", flush=True)


if __name__ == "__main__":
    main()
