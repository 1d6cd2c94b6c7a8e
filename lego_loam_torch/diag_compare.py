"""Two runs of the campus course held frame by frame: the trajectories that
`python -m lego_loam_torch.diag_campus` (diag_traj_torch.npz in the
temporary directory) and tools/diag_campus.py (/tmp/diag_traj.npz) write,
each with `est` (the map position of every frame), `odom` (the odometry
position) and `gt` (the truth).

    python -m lego_loam_torch.diag_compare A.npz B.npz [--straight 150] [--turn 25] [--part 0.02]

Prints, for the frames both runs reached (their truths must agree): the
first frame at which the map positions and the odometry positions part by
more than --part metres; then, segment by segment of the course (straight,
turn, straight, ...; `lap_trajectory`'s sides), the map and odometry
difference at the segment's last frame and its largest within it, and
each run's mean and largest odometry step error |d_odom - d_gt| there
(`diag_campus`'s segments and step errors); then the map error against
the truth at the last frame, and each run's map ATE over the frames (no
alignment).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .diag_campus import segment_steps, segments, step_errors


def first_parting(a, b, limit: float) -> int | None:
    """The first frame at which |a - b| exceeds `limit`, or None."""
    over = np.flatnonzero(np.linalg.norm(np.asarray(a) - np.asarray(b), axis=1) > limit)
    return int(over[0]) if len(over) else None


def compare(a: dict, b: dict, straight: int, turn: int, part: float = 0.02) -> dict:
    """Runs `a` and `b` (each with est, odom and gt) over their common
    frames: the first frames past `part`, and per segment the map and
    odometry differences (at its last frame, largest within it) and each
    run's odometry step errors (mean, largest; `segment_steps`, the rule of
    `diag_campus.segment_step_errors`)."""
    n = min(len(a["est"]), len(b["est"]))
    gt = np.asarray(a["gt"])[:n]
    if not np.allclose(gt, np.asarray(b["gt"])[:n], atol=1e-6):
        raise ValueError("the two runs are not over the same course")
    ea, eb, oa, ob = (np.asarray(x)[:n] for x in (a["est"], b["est"], a["odom"], b["odom"]))
    dmap, dodom = np.linalg.norm(ea - eb, axis=1), np.linalg.norm(oa - ob, axis=1)
    sa, sb = step_errors(oa, gt), step_errors(ob, gt)
    rows = []
    for name, lo, hi in segments(n, straight, turn):
        ra, rb = segment_steps(sa, lo, hi), segment_steps(sb, lo, hi)
        row = {"segment": name, "frames": [lo, hi - 1], "map_diff_end_m": float(dmap[hi - 1]),
               "map_diff_max_m": float(dmap[lo:hi].max()), "odom_diff_end_m": float(dodom[hi - 1]),
               "odom_diff_max_m": float(dodom[lo:hi].max())}
        if len(ra):
            row.update(step_err_a_cm=[float(ra.mean() * 100), float(ra.max() * 100)],
                       step_err_b_cm=[float(rb.mean() * 100), float(rb.max() * 100)])
        rows.append(row)
    return {
        "frames": n,
        "first_map_parting": first_parting(ea, eb, part),
        "first_odom_parting": first_parting(oa, ob, part),
        "part_m": part,
        "segments": rows,
        "map_err_end_m": [float(np.linalg.norm(ea[-1] - gt[-1])), float(np.linalg.norm(eb[-1] - gt[-1]))],
        "map_ate_m": [float(np.sqrt(np.mean(np.sum((e - gt) ** 2, axis=1)))) for e in (ea, eb)],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--straight", type=int, default=150)
    ap.add_argument("--turn", type=int, default=25)
    ap.add_argument("--part", type=float, default=0.02, help="metres apart that count as parted")
    args = ap.parse_args(argv)
    with np.load(args.a) as fa, np.load(args.b) as fb:
        res = compare(dict(fa), dict(fb), args.straight, args.turn, args.part)
    print(f"{res['frames']} common frames; first frame parted by > {args.part} m: map {res['first_map_parting']}, "
          f"odometry {res['first_odom_parting']}")
    print("segment     frames       map diff end/max m   odom diff end/max m   step err A mean/max cm   "
          "step err B mean/max cm")
    for r in res["segments"]:
        sa, sb = r.get("step_err_a_cm", [np.nan] * 2), r.get("step_err_b_cm", [np.nan] * 2)
        print(f"{r['segment']:10s}  {r['frames'][0]:5d}-{r['frames'][1]:<5d}  {r['map_diff_end_m']:8.4f} "
              f"{r['map_diff_max_m']:8.4f}    {r['odom_diff_end_m']:8.4f} {r['odom_diff_max_m']:8.4f}     "
              f"{sa[0]:7.2f} {sa[1]:7.2f}            {sb[0]:7.2f} {sb[1]:7.2f}")
    print(f"map error at the last frame: A {res['map_err_end_m'][0]:.4f} m, B {res['map_err_end_m'][1]:.4f} m; "
          f"map ATE: A {res['map_ate_m'][0]:.4f} m, B {res['map_ate_m'][1]:.4f} m")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
