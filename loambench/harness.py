"""What every cell of the benchmark shares: the files found by name, the
configuration built from its file, the host spans, the result line and the
check that no JAX module was loaded.

A cell (`BENCHMARK.json`'s `workloads`) names a configuration and a traffic
mix. The configuration's `file` holds the port's `LegoLoamConfig` as run
(key `lego`); the mix is `traffic/<name>.json`, whose `driver` names
`drivers/<driver>.py`; each metric is read by `metrics/<name>.py`; each
cell's limits for `correct` are in `limits/<cell>.json`. A new cell, mix,
driver or metric is new files and new entries of `BENCHMARK.json`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
import typing
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lego_loam_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (the part before the first dot),
    compared whole, is JAX's, jaxlib's, flax's or the JAX package's."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def set_cache_dirs():
    """Fixed directories inside the checkout for every kernel cache a run
    may fill (the port builds its own kernels under its `_build/`), and
    no flax behind `transformers`."""
    cache = PKG / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def load_bench(path: Path | None = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def read_json(rel: str, root: Path = ROOT) -> dict:
    with open(root / rel) as f:
        return json.load(f)


def traffic(name: str, root: Path = ROOT) -> dict:
    return read_json(f"loambench/traffic/{name}.json", root)


def limits(cell: str, root: Path = ROOT) -> dict:
    return read_json(f"loambench/limits/{cell}.json", root)


def driver(kind: str):
    return importlib.import_module(f"loambench.drivers.{kind}")


def _load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """`read(record) -> float | None` of metrics/<name>.py (None: nothing
    to read in this run, and the metric is left out)."""
    path = root / "loambench" / "metrics" / f"{name}.py"
    return _load_file(path, f"loambench_metric_{name.replace('.', '_')}").read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a run of `cell` reports: its end-to-end metrics with
    --trace 0, its per-layer metrics with --trace 1."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def build_dataclass(cls, values: dict):
    """An instance of the (nested, frozen) dataclass `cls` from a dict as
    `dataclasses.asdict` gives it; a key it does not have is refused."""
    hints = typing.get_type_hints(cls)
    fields = {f.name: f for f in dataclasses.fields(cls)}
    extra = set(values) - set(fields)
    if extra:
        raise KeyError(f"{cls.__name__} has no field {sorted(extra)}")
    kw = {}
    for k, v in values.items():
        t = hints[k]
        if dataclasses.is_dataclass(t):
            kw[k] = build_dataclass(t, v)
        elif isinstance(v, list):
            kw[k] = tuple(v)
        else:
            kw[k] = v
    return cls(**kw)


def lego_config(cls, entry: dict, overrides: dict | None = None, root: Path = ROOT):
    """The configuration file's `lego` section as an instance of `cls`
    (the port's or the reference's LegoLoamConfig), with `overrides`
    ({section: {key: value}}) applied on top (tests only)."""
    values = read_json(entry["file"], root)["lego"]
    for section, kv in (overrides or {}).items():
        values[section].update(kv)
    return build_dataclass(cls, values)


class Spans:
    """Host spans by name, on the host clock (seconds), kept in memory;
    with `profiler_marks` each is also a `record_function` range, so a
    device trace shows which span was open."""

    def __init__(self):
        self.spans: dict = {}
        self.profiler_marks = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        mark = contextlib.nullcontext()
        if self.profiler_marks:
            import torch

            mark = torch.profiler.record_function(f"loambench.{name}")
        t0 = time.perf_counter()
        with mark:
            yield
        self.spans.setdefault(name, []).append((t0, time.perf_counter()))

    def durations(self, name: str) -> list:
        return [b - a for a, b in self.spans.get(name, [])]


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict, checks: list,
                breakdown: dict | None = None) -> str:
    """The last line of standard output: `checks` (each compared number
    beside its limit) comes last."""
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed), "metrics": metrics,
            "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return json.dumps(line)
