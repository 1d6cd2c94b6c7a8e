#!/usr/bin/env python3
"""The port's half of tests/test_torch_pipeline.py (six swept scans through
`run_chunked(chunk=3)`, from the reference's initial states with its RANSAC
draws) at given numbers of torch intra-op threads, held against the
reference's chunk runner on the same scans.

    JAX_PLATFORMS=cpu python tests/probe_torch_threads.py [THREADS ...]   # default: 1 2 4 8

Runs the drive twice at each thread count, in the order given, and prints
the largest difference of the first two map poses from the reference's
(the test checks 0.1 mm) and of all map poses from the first run's. Start
several at once to see the effect of other processes on the cores.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path[:0] = [os.path.join(os.path.dirname(os.path.abspath(__file__)), p) for p in ("..", ".")]

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
import numpy as np  # noqa: E402
import torch  # noqa: E402

import _torch_parity  # noqa: E402,F401  (pins one thread; set again below)
from _torch_parity import pair, ref_scores, small_ref_cfg  # noqa: E402
from lego_loam_tpu.pipeline import LegoLoamPipeline as RefPipeline  # noqa: E402
from lego_loam_torch.convert import backend_state_from_reference, odometry_state_from_reference  # noqa: E402
from lego_loam_torch.io.synthetic import straight_trajectory, swept_scan_sequence  # noqa: E402
from lego_loam_torch.pipeline import LegoLoamPipeline  # noqa: E402


def main():
    counts = [int(a) for a in sys.argv[1:]] or [1, 2, 4, 8]
    ref_cfg, cfg = pair(small_ref_cfg(max_keyframes=32))
    scans = list(swept_scan_sequence(straight_trajectory(6, speed=0.15), cfg, noise=0.005))
    ref = RefPipeline(ref_cfg)
    start = jax.device_get(ref.fstate), jax.device_get(ref.bstate)
    ref.process_chunk(ref._prep_many(scans))
    ref.finalize()
    ref_map = np.stack(ref.trajectory["positions"])
    first = None
    for threads in counts:
        torch.set_num_threads(threads)
        for r in range(2):
            ours = LegoLoamPipeline(cfg, device="cpu", ground_scores=lambda i: ref_scores(cfg, i))
            ours.fstate = odometry_state_from_reference(start[0], "cpu")
            ours.bstate = backend_state_from_reference(start[1], "cpu")
            m = ours.run_chunked(scans, chunk=3)["map_positions"]
            first = m if first is None else first
            print(f"{torch.get_num_threads()} threads, run {r}: first two map poses within "
                  f"{np.abs(m[:2] - ref_map[:2]).max():.3g} m of the reference's; all map poses within "
                  f"{np.abs(m - first).max():.3g} m of the first run's", flush=True)


if __name__ == "__main__":
    main()
