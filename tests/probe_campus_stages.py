"""Probe (on the CPU; not a test): does the port part from the JAX package
within one frame, or only as the frames accumulate? The repo's method of
isolating a fault: feed the port, at every frame, the reference's state
after the frame before.

    JAX_PLATFORMS=cpu python tests/probe_campus_stages.py [--frames 16] [--straight 5] [--turn 4] [--full]

The course is `diag_campus`'s (the first --frames of `lap_trajectory(3,
straight, turn)` in the campus world of the whole course, frame i seeded
100 + i), on tests/test_torch_diag_campus.py's cut `vlp16()` (32
keyframes, 1,024 corner and 2,048 surf submap slots; --full: `vlp16()`
as it is), loop closure off, one frame a chunk. The reference drives every
frame; after each, its odometry and backend states go (through
`lego_loam_torch.convert`) into a fresh port pipeline at that frame index,
which drives the next frame with the reference's RANSAC draws. Printed per
frame: the segment, how far the port's restarted frame lands from the
reference's (the map pose's and the odometry's world position after the
frame, and the odometry's motion M), and how far a continuous port run
(the same draws, from the reference's initial states) lies from the
reference. A fault shows as a
one-frame difference well above the flat-feature ties (ROADMAP §3: ~2 mm
of scan-to-scan solve from the same state); ties that only accumulate
show as small one-frame differences under a growing continuous one.
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from _torch_parity import ref_scores  # noqa: E402
from lego_loam_tpu.config import vlp16 as ref_vlp16  # noqa: E402
from lego_loam_tpu.pipeline import LegoLoamPipeline as RefPipeline  # noqa: E402
from lego_loam_torch import diag_campus  # noqa: E402
from lego_loam_torch.convert import (  # noqa: E402
    backend_state_from_reference, config_from_reference, odometry_state_from_reference,
)
from lego_loam_torch.pipeline import LegoLoamPipeline  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--straight", type=int, default=5)
    ap.add_argument("--turn", type=int, default=4)
    ap.add_argument("--full", action="store_true", help="vlp16() as it is, not the test's cut")
    args = ap.parse_args(argv)
    ref_cfg = ref_vlp16()
    if not args.full:
        ref_cfg = dataclasses.replace(ref_cfg, mapping=dataclasses.replace(
            ref_cfg.mapping, max_keyframes=32, max_submap_corner=1024, max_submap_surf=2048))
    cfg = config_from_reference(ref_cfg)
    dargs = diag_campus.parse_args(["--device", "cpu", "--frames", str(args.frames), "--straight",
                                    str(args.straight), "--turn", str(args.turn)])
    _, jobs = diag_campus.course(dargs, cfg)
    scans = diag_campus.render_swept(jobs)

    def port(start_f, start_b, frame):
        pipe = LegoLoamPipeline(cfg, device="cpu", ground_scores=lambda i: ref_scores(cfg, i))
        pipe.fstate = odometry_state_from_reference(start_f, "cpu")
        pipe.bstate = backend_state_from_reference(start_b, "cpu")
        pipe.frame_idx = frame
        return pipe

    ref = RefPipeline(ref_cfg)
    cont = port(jax.device_get(ref.fstate), jax.device_get(ref.bstate), 0)
    print("frame seg       restart: map mm  odom mm  M mm   | continuous: map mm  odom mm")
    for k, scan in enumerate(scans):
        start = jax.device_get(ref.fstate), jax.device_get(ref.bstate)
        ref.process_chunk(ref._prep_many([scan]))
        r_map, r_odom, r_M = (np.asarray(jax.device_get(x)) for x in (
            ref.bstate.t_map, ref.fstate.t_world, ref.fstate.t_prev_cur))
        one = port(*start, k)
        one.process_chunk(one._prep_many([scan]))
        o_map, o_odom, o_M = (x.numpy() for x in (one.bstate.t_map, one.fstate.t_world, one.fstate.t_prev_cur))
        cont.process_chunk(cont._prep_many([scan]))
        c_map, c_odom = cont.bstate.t_map.numpy(), cont.fstate.t_world.numpy()
        mm = lambda a, b: 1e3 * float(np.linalg.norm(a - b))  # noqa: E731
        print(f"{k:5d} {diag_campus.segment(k, args.straight, args.turn):8s}  {mm(o_map, r_map):8.3f} "
              f"{mm(o_odom, r_odom):8.3f} {mm(o_M, r_M):7.3f}  | {mm(c_map, r_map):10.3f} {mm(c_odom, r_odom):8.3f}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
