"""The benchmark of the PyTorch/CUDA port (`lego_loam_torch`) on the H100.

    python3 -m loambench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (`BENCHMARK.json`'s `workloads`)
names a configuration and a traffic mix; the mix's driver
(`drivers/<driver>.py`) renders its course from the seed on the card,
sets up the pipeline, measures for --seconds and checks the window's
outputs against the plain reference (`check.py`). The last line of
standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics with --trace 0, its per-layer
metrics with --trace 1, each read by `metrics/<name>.py`), `device`, with
--trace 1 `breakdown`, and last `checks`, each compared number with its
limit, which also end standard error.

Exits 2 without printing a result when no CUDA device is visible, when
fewer cards are visible than the cell asks for, or when a module of JAX,
jaxlib, flax or the JAX package is loaded at the end of the run.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from . import harness  # noqa: E402


@dataclasses.dataclass
class Run:
    """One run of one cell, as its driver sees it."""

    cell: str
    cfg: object  # the port's LegoLoamConfig
    cfg_ref: object  # the reference's LegoLoamConfig (the same file)
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    control: bool = False  # also run the control (loambench.control only)
    spans: harness.Spans = dataclasses.field(default_factory=harness.Spans)

    @property
    def pipe_seed(self) -> int:
        return self.seed % (2 ** 31)

    def log(self, msg: str):
        print(f"[{time.perf_counter() - self.t_start:8.2f} s] {msg}", file=sys.stderr, flush=True)

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def free(self):
        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def prepare(bench: dict, cell: str, seed: int, seconds: float, trace: bool, device, overrides=None,
            t_start: float | None = None) -> Run:
    """The run of `cell`: its configuration for the port and the reference
    (overrides: tests only), its mix and limits."""
    from lego_loam_torch.config import LegoLoamConfig

    from .reference.lego.config import LegoLoamConfig as RefConfig

    w = harness.workload(bench, cell)
    entry = harness.config_entry(bench, w["config"])
    overrides = overrides or {}
    mix = dict(harness.traffic(w["traffic"]), **overrides.get("traffic", {}))
    return Run(cell=cell, cfg=harness.lego_config(LegoLoamConfig, entry, overrides.get("lego")),
               cfg_ref=harness.lego_config(RefConfig, entry, overrides.get("lego")), mix=mix, seed=seed,
               seconds=seconds, trace=trace, device=device,
               t_start=T_START if t_start is None else t_start)


def execute(bench: dict, r: Run) -> tuple:
    """Drive the cell; returns (result dict, checks)."""
    import torch

    rec = harness.driver(r.mix["driver"]).run(r)
    rec["spans"] = r.spans
    from .check import judged, passed

    checks = judged(rec["readings"], harness.limits(r.cell))
    metrics = {}
    for m in harness.cell_metrics(bench, r.cell, r.trace):
        value = harness.metric_reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if r.device.type == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(r.device) if r.device.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    breakdown = None
    if r.trace:
        from .roofline import busy
        from .trace import summary

        ops = rec["trace"].ops
        if not ops:
            raise RuntimeError("the profiler saw no device operation in the traced sub-window")
        device["busy_s"] = busy([(s, e) for _, s, e in ops])
        device["window_s"] = max(e for _, _, e in ops) - min(s for _, s, _ in ops)
        breakdown = summary(ops, rec["trace"].marks)
    r.log(f"info {json.dumps(rec['info'])}")
    r.log(f"readings {json.dumps(rec['readings'])}")
    r.log(f"power limit: {power_limit()}")
    result = {"correct": passed(checks), "attempted": rec["attempted"], "failed": rec["failed"],
              "metrics": metrics, "device": device, "breakdown": breakdown}
    return result, checks


def main(argv=None) -> int:
    args = parse_args(argv)
    harness.set_cache_dirs()
    bench = harness.load_bench()
    w = harness.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"loambench: the cell needs {w['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible", file=sys.stderr)
        return 2
    r = prepare(bench, args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    result, checks = execute(bench, r)
    found = harness.forbidden_modules()
    if found:
        print(f"loambench: modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 2
    for c in checks:
        ok = math.isfinite(c["value"]) and c["value"] <= c["limit"]
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} {'ok' if ok else 'FAILED'}",
              file=sys.stderr, flush=True)
    print(harness.result_line(result["correct"], result["attempted"], result["failed"], result["metrics"],
                              result["device"], checks, result["breakdown"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
