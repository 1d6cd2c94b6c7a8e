"""The readings that set each limit of `correct`, on the chip: for each
seed, one run of the cell with a short window, then the reference from the
port's state twice, in float32 (TF32 off, as the configuration states) and
in TF32 (the control, the reference put in the port's place one precision
below). Prints one JSON line a seed: the sound readings (the port against
the reference) and the control's (the TF32 reference against it).

    python3 -m loambench.control --workload vlp16.replay.lap --seeds 11,12,13 --seconds 4

The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import harness, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="run the control on the first this many seeds only (default: all)")
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("loambench.control: no CUDA device is visible", file=sys.stderr)
        return 2
    bench = harness.load_bench()
    seeds = [int(s) for s in args.seeds.split(",")]
    n_control = len(seeds) if args.control_seeds is None else args.control_seeds
    for i, seed in enumerate(seeds):
        r = run.prepare(bench, args.workload, seed, args.seconds, False, torch.device("cuda", 0),
                        t_start=time.perf_counter())
        r.control = i < n_control
        rec = harness.driver(r.mix["driver"]).run(r)
        print(json.dumps({"workload": args.workload, "seed": seed, "sound": rec["readings"],
                          "control": rec["control"], "setup_s": rec["setup_s"], "info": rec["info"]}), flush=True)
        del rec, r
    return 0


if __name__ == "__main__":
    sys.exit(main())
