"""The harness without a card: the JAX-free check, each configuration file
against the port's preset, BENCHMARK.json against the benchmark's
contract, and a new configuration, mix, driver and metric found by name
from new files alone."""

import dataclasses
import json
import re
import shutil
import subprocess
import sys

import pytest

from lego_loam_torch.config import LegoLoamConfig, hdl64e, vlp16
from loambench import harness
from loambench.reference.lego.config import LegoLoamConfig as RefConfig

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_forbidden_modules_compare_top_level_names_whole():
    mods = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "lego_loam_tpu", "lego_loam_tpu.ops.knn",
            "lego_loam_torch", "lego_loam_torch.ops", "jaxtyping", "jax_cosmo", "lego_loam_tpux", "numpy"]
    assert harness.forbidden_modules(mods) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "lego_loam_tpu", "lego_loam_tpu.ops.knn"])


def test_the_run_and_the_reference_load_no_jax():
    code = ("import sys; import loambench.run, loambench.check, loambench.drivers.replay, "
            "loambench.reference.lego.pipeline; from loambench.harness import forbidden_modules; "
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys, loambench.reference.lego.pipeline; "
            "print(sorted({m.split('.')[0] for m in sys.modules if m.startswith('lego')}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
    for path in (ROOT / "loambench" / "reference").rglob("*.py"):
        text = path.read_text()
        assert not re.search(r"^\s*(from|import)\s+(lego_loam_torch|lego_loam_tpu|jax)\b", text, re.M), path


@pytest.mark.parametrize("name, preset", [("vlp16", vlp16), ("hdl64e", hdl64e)])
def test_configuration_files_are_the_presets_with_loop_closure(name, preset):
    bench = harness.load_bench()
    entry = harness.config_entry(bench, name)
    cfg = preset()
    want = dataclasses.replace(cfg, mapping=dataclasses.replace(cfg.mapping, enable_loop_closure=True,
                                                               max_keyframes=20480))
    assert harness.lego_config(LegoLoamConfig, entry) == want
    ref = harness.lego_config(RefConfig, entry)
    assert dataclasses.asdict(ref) == dataclasses.asdict(want)
    assert harness.read_json(entry["file"])["reduced"] == entry["reduced"] == []


def test_benchmark_json_keeps_to_the_contract():
    bench = harness.load_bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16 and all(not p.startswith("/") and ".." not in p for p in bench["paths"])
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("loambench/") and (ROOT / c["file"]).exists()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    cells = [w["name"] for w in bench["workloads"]]
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(cells)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in names and w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "loambench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "loambench" / "limits" / f"{w['name']}.json").exists()
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "loambench" / "metrics" / f"{m['name']}.py").exists()
        assert set(m["workloads"]) <= set(cells) if "workloads" in m else True
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        moved = next(x for x in bench["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:
        assert harness.cell_metrics(bench, cell, False) and harness.cell_metrics(bench, cell, True)
        assert "setup_s" in {m["name"] for m in harness.cell_metrics(bench, cell, False)}
    assert len(json.dumps(bench)) <= 64 * 1024


def test_a_new_cell_is_new_files_and_entries_alone(tmp_path):
    """A later change adds a configuration, a mix (with its driver) and a
    metric by files and BENCHMARK.json entries; the harness finds each by
    name, with no file of its own edited."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "loambench", root / "loambench", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = harness.load_bench()
    cfg = json.loads((ROOT / "loambench/configs/vlp16.json").read_text())
    cfg["lego"]["laser"]["num_vertical_scans"] = 32
    (root / "loambench/configs/vlp32.json").write_text(json.dumps(cfg))
    (root / "loambench/traffic/replay_short.json").write_text(json.dumps({"driver": "replay", "laps": 1}))
    (root / "loambench/metrics/frames_total.py").write_text("def read(rec):\n    return float(rec['scans'])\n")
    (root / "loambench/limits/vlp32.replay.short.json").write_text(json.dumps({"map_pos_gap_m": 1.0}))
    bench["configs"].append({"name": "vlp32", "source": "x", "file": "loambench/configs/vlp32.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "vlp32.replay.short", "config": "vlp32", "traffic": "replay_short",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "frames_total", "unit": "scans", "better": "higher", "source": "host_clock",
                               "layer": "drive and feed", "moves": "scans_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    bench = harness.load_bench(root / "BENCHMARK.json")
    w = harness.workload(bench, "vlp32.replay.short")
    got = harness.lego_config(LegoLoamConfig, harness.config_entry(bench, w["config"]), root=root)
    assert got.laser.num_vertical_scans == 32
    mix = harness.traffic(w["traffic"], root)
    assert harness.driver(mix["driver"]).run is not None
    assert harness.limits(w["name"], root) == {"map_pos_gap_m": 1.0}
    assert "frames_total" in {m["name"] for m in harness.cell_metrics(bench, w["name"], True)}
    assert harness.metric_reader("frames_total", root)({"scans": 7}) == 7.0
    for rel in ("loambench/harness.py", "loambench/run.py", "loambench/check.py", "loambench/drivers/replay.py"):
        assert (root / rel).read_bytes() == (ROOT / rel).read_bytes()
