"""`python -m lego_loam_torch.campus_run` against `tools/campus_run.py`: the
synthetic IMU and wheel-odometry streams bit for bit, and a tiny course
through the tool (the reference) and through the port's functions on the
CPU, the port from the reference's start states and RANSAC draws.

The course is one lap of `lap_trajectory(1, 1, 5)` (24 frames, 18 deg a
turning frame) in chunks of 8, loop candidates older than 1.2 s, on
`loop_ref_cfg` with the submap held to 1,024 corner and 2,048 surf slots,
8 ICP iterations and 2 history keyframes a side, so that each package's
run takes ~50-70 s here. Both close the loop twice. Measured differences
of the records: map ATE 3.5e-3 m, corrected keyframe ATE 1.7e-3 m,
odometry ATE 1.24e-2 m, RPE 6.5e-3 m (map) and 1e-4 m (odometry); they are
held to the slice's bounds (map 1.5 cm, odometry 8 cm)."""

import dataclasses
import importlib.util
import io
import json
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import lego_loam_tpu.config as ref_config
from lego_loam_tpu.pipeline import LegoLoamPipeline as RefPipeline
from lego_loam_torch import campus_run
from lego_loam_torch.convert import backend_state_from_reference, config_from_reference, odometry_state_from_reference
from lego_loam_torch.io import synthetic
from lego_loam_torch.pipeline import LegoLoamPipeline

from _torch_parity import loop_ref_cfg, ref_scores

ROOT = Path(__file__).resolve().parent.parent
COURSE = ["--laps", "1", "--straight", "1", "--turn", "5", "--chunk", "8", "--render-variants", "1",
          "--time-gap", "1.2", "--max-keyframes", "32"]
MAP_TOL, ODOM_TOL = 1.5e-2, 8e-2
# the JAX package's own records and output directories
REFERENCE_OUTPUTS = {"CAMPUS_RUN.json", "CAMPUS_IMU_ODOM.json", "STEVENS_RUN.json", "out_campus", "out_stevens"}


def load_tool():
    """tools/campus_run.py as a module. Importing it adds the tools
    directory to sys.path (its main imports the scan cache from there), so
    callers patch sys.path around it."""
    spec = importlib.util.spec_from_file_location("reference_campus_run", ROOT / "tools" / "campus_run.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def course_base():
    """`loop_ref_cfg` cut for the CPU: smaller submap caps, fewer ICP
    iterations and history keyframes (the same for both packages)."""
    cfg = loop_ref_cfg(32)
    return dataclasses.replace(cfg, mapping=dataclasses.replace(
        cfg.mapping, max_submap_corner=1024, max_submap_surf=2048, loop_icp_max_iterations=8,
        history_keyframe_search_num=2,
    ))


def test_synth_streams_bit_equal_to_tool():
    """`synth_imu_windows` and `synth_wheel_odom` of the port (numpy
    copies) against the tool's on a 2-lap course at the default laps."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "path", list(sys.path))
        tool = load_tool()
    ref_cfg = ref_config.vlp16()
    cfg = config_from_reference(ref_cfg)
    poses = synthetic.lap_trajectory(2, 150, 25)
    a, b = tool.synth_imu_windows(poses, ref_cfg), synthetic.synth_imu_windows(poses, cfg)
    assert sorted(a) == sorted(b) == ["acc", "mask", "rpy", "t"]
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert a["mask"].sum() > 0
    (Ra, ta), (Rb, tb) = tool.synth_wheel_odom(poses, ref_cfg), synthetic.synth_wheel_odom(poses, cfg)
    assert Ra.dtype == Rb.dtype and np.array_equal(Ra, Rb) and np.array_equal(ta, tb)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The tool's main over the course (its config `course_base()` through
    a patched `vlp16`), then the port's functions over the same course
    from the reference's start states, each writing its outputs under a
    temporary directory and rendering into its own scan cache there."""
    tmp = tmp_path_factory.mktemp("campus")
    base = course_base()
    saved = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir", "jax_persistent_cache_min_entry_size_bytes",
        "jax_persistent_cache_min_compile_time_secs")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "path", list(sys.path))
        tool = load_tool()
        import scan_cache

        mp.setattr(scan_cache, "CACHE_DIR", str(tmp / "ref_cache"))
        mp.setattr(ref_config, "vlp16", lambda: base)
        mp.setattr(sys, "argv", ["campus_run.py", *COURSE, "--out", str(tmp / "ref_out"),
                                 "--json-out", str(tmp / "ref.json")])
        tool.main()
    for k, v in saved.items():  # the tool turns on jax's persistent cache
        jax.config.update(k, v)
    with open(tmp / "ref.json") as f:
        ref_rec = json.load(f)

    args = campus_run.parse_args(["--device", "cpu", *COURSE, "--out", str(tmp / "out"),
                                  "--json-out", str(tmp / "ours.json")])
    ref_cfg = campus_run.campus_config(args, base)
    cfg = config_from_reference(ref_cfg)
    ref = RefPipeline(ref_cfg)  # its initial states are the tool's pipeline's
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LEGO_SCAN_CACHE", str(tmp / "cache"))
        course = campus_run.build_course(args, cfg)
    pipe = LegoLoamPipeline(cfg, device="cpu", ground_scores=lambda i: ref_scores(cfg, i))
    pipe.fstate = odometry_state_from_reference(jax.device_get(ref.fstate), "cpu")
    pipe.bstate = backend_state_from_reference(jax.device_get(ref.bstate), "cpu")
    timing = campus_run.run_course(pipe, course, args.chunk)
    launches = campus_run.launch_record(pipe)
    result = campus_run.course_result(pipe, course, args, timing, campus_run.latency_probe(pipe), "cpu")
    campus_run.write_outputs(pipe, result, launches, args.out, args.json_out)
    return ref_rec, result, args


def test_course_matches_reference(runs):
    """The same frames, keyframes and closures (at least one); the ATEs
    and RPEs within the slice's bounds of the reference's (which rounds
    them to 0.1 mm); both finite and not failed."""
    ref, ours, _ = runs
    for k in ("frames", "keyframes_total", "loop_closures", "max_keyframes", "finite", "failed", "laps", "imu",
              "odom_prior"):
        assert ours[k] == ref[k], (k, ours[k], ref[k])
    assert ours["frames"] == 24 and ours["loop_closures"] >= 1
    assert ours["finite"] and not ours["failed"]
    for k, tol in (("ate_map_m", MAP_TOL), ("ate_corrected_kf_m", MAP_TOL), ("rpe_100m_map", MAP_TOL),
                   ("ate_odom_only_m", ODOM_TOL), ("rpe_100m_odom", ODOM_TOL)):
        assert abs(ours[k] - ref[k]) <= tol + 5e-5, (k, ours[k], ref[k])


def test_record_and_products(runs):
    """The record has CAMPUS_RUN.json's keys plus `device`, the peak device
    memory (None on the CPU) and the store probes (none asked), and the file
    written holds it; the artifacts, the map, loop_diag.json and
    launches.json are written."""
    _, ours, args = runs
    with open(ROOT / "CAMPUS_RUN.json") as f:
        keys = set(json.load(f))
    assert set(ours) == keys | {"device", "peak_device_memory_gib", "latency_by_keyframes"}
    assert ours["device"] == "cpu" and ours["peak_device_memory_gib"] is None and ours["latency_by_keyframes"] == []
    with open(args.json_out) as f:
        assert json.load(f) == ours
    out = Path(args.out)
    for name in ("pose.txt", "mapt.txt", "MapIterTimes.txt", "LocalInfo.txt", "cornerMap.pcd", "surfaceMap.pcd",
                 "trajectory.pcd"):
        assert (out / name).stat().st_size > 0, name
    with open(out / "loop_diag.json") as f:
        diag = json.load(f)
    assert sum(1 for d in diag if d.get("accepted")) == ours["loop_closures"]
    with open(out / "launches.json") as f:
        assert sorted(json.load(f)) == ["graph_stats", "launches", "launches_by_site"]


class Recorded(Exception):
    """Raised by the stand-in pipelines once they have the config."""


# the Stevens-scale configuration (README.md; its loop settings inferred
# from out_stevens/loop_diag.json), the IMU variant and the defaults
MAIN_FLAGS = {
    "stevens": ["--laps", "8", "--straight", "600", "--turn", "25", "--imu", "--odom", "--loop-cap", "256",
                "--time-gap", "150", "--radius", "25"],
    "imu_odom": ["--imu", "--odom"],
    "defaults": [],
}


@pytest.mark.parametrize("name", MAIN_FLAGS)
def test_main_config_and_course_match_tool(name, tmp_path):
    """The tool's main and the port's, each up to its pipeline with the
    renders recorded and skipped: the configs equal field by field, the
    same lap renders asked for (tag and parameters), and the same course;
    the Stevens flags give 20,000 frames in 8 laps of 2,500 (625 chunks of
    32), more loop factors than the 173 of STEVENS_RUN.json."""
    flags = MAIN_FLAGS[name]
    seen = {"ref": [], "ours": []}

    def recorder(side):
        def get_or_render(tag, params, fn):
            seen[side].append((tag, params))
            return [None] * (params["lap_len"] + 1)
        return get_or_render

    def stand_in(side):
        def make(cfg, **kw):
            seen[side].append(cfg)
            raise Recorded
        return make

    saved = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir", "jax_persistent_cache_min_entry_size_bytes",
        "jax_persistent_cache_min_compile_time_secs")}
    ref_log, our_log = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "path", list(sys.path))
        tool = load_tool()
        import lego_loam_tpu.pipeline as ref_pipeline
        import scan_cache

        mp.setattr(scan_cache, "get_or_render", recorder("ref"))
        mp.setattr(ref_pipeline, "LegoLoamPipeline", stand_in("ref"))
        mp.setattr(sys, "argv", ["campus_run.py", *flags, "--out", str(tmp_path / "ref_out"),
                                 "--json-out", str(tmp_path / "ref.json")])
        with pytest.raises(Recorded), redirect_stdout(ref_log):
            tool.main()
    for k, v in saved.items():
        jax.config.update(k, v)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(campus_run, "get_or_render", recorder("ours"))
        mp.setattr(campus_run, "LegoLoamPipeline", stand_in("ours"))
        with pytest.raises(Recorded), redirect_stdout(our_log):
            campus_run.main(["--device", "cpu", *flags, "--out", str(tmp_path / "out"),
                             "--json-out", str(tmp_path / "ours.json")])
    *ref_renders, ref_cfg = seen["ref"]
    *our_renders, our_cfg = seen["ours"]
    assert dataclasses.asdict(config_from_reference(ref_cfg)) == dataclasses.asdict(our_cfg)
    assert ref_renders == our_renders
    course = [line for line in ref_log.getvalue().splitlines() if line.startswith("course:")]
    assert course and course == [line for line in our_log.getvalue().splitlines() if line.startswith("course:")]
    args = campus_run.parse_args(["--device", "cpu", *flags])
    n = len(synthetic.lap_trajectory(args.laps, args.straight, args.turn))
    assert our_renders[0][1]["lap_len"] == n // args.laps and len(our_renders) == args.render_variants
    if name == "stevens":
        m = our_cfg.mapping
        assert n == 20000 and n % args.chunk == 0 and our_renders[0][1]["lap_len"] == 2500
        assert m.max_keyframes == 20480 and m.max_loop_factors >= 173 and m.enable_loop_closure
        assert our_cfg.pipeline.use_imu_undistortion and our_cfg.odometry.odom_prior_mode == "init"


@pytest.mark.parametrize("flags,offset,sync_free", [([], 0, None), (["--noise-seed", "2", "--host-step"], 200_000, False)],
                         ids=["defaults", "noise_seed_host_step"])
def test_noise_seed_and_host_step(flags, offset, sync_free, tmp_path):
    """The port's main up to its pipeline, renders recorded: --noise-seed K
    offsets every render's seed (9000 v + 100 + i) by 100,000 K and keys
    the scan cache by K; --host-step asks the pipeline for sync_free=False.
    Without them, the tool's seeds, its cache parameters and the default
    step."""
    seen = {"params": [], "seeds": [], "kw": []}

    def get_or_render(tag, params, fn):
        seen["params"].append(params)
        return fn()

    def render_swept(jobs, pool=None):
        seen["seeds"].append([j[-1] for j in jobs])
        return [None] * len(jobs)

    def stand_in(cfg, **kw):
        seen["kw"].append(kw)
        raise Recorded

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(campus_run, "get_or_render", get_or_render)
        mp.setattr(campus_run, "render_swept", render_swept)
        mp.setattr(campus_run, "RENDER_WORKERS", 1)
        mp.setattr(campus_run, "LegoLoamPipeline", stand_in)
        with pytest.raises(Recorded), redirect_stdout(io.StringIO()):
            campus_run.main(["--device", "cpu", "--laps", "1", "--straight", "3", "--turn", "1",
                             "--render-variants", "2", *flags, "--out", str(tmp_path / "out"),
                             "--json-out", str(tmp_path / "ours.json")])
    lap_len = 16
    assert seen["seeds"] == [[9000 * v + 100 + i + offset for i in range(lap_len + 1)] for v in range(2)]
    assert [p.get("noise_seed", 0) for p in seen["params"]] == [offset // 100_000] * 2
    assert seen["kw"] == [{"device": torch.device("cpu"), "sync_free": sync_free}]


def test_defaults_write_no_reference_output():
    """The defaults (the tool's flags and defaults, plus --device) write
    nothing of the JAX package's: the record is
    CAMPUS_RUN_torch.json and the products go to a gitignored directory."""
    args = campus_run.parse_args(["--device", "cpu"])
    tool_defaults = dict(laps=3, straight=150, turn=25, chunk=32, max_keyframes=20480, render_variants=3,
                         no_loop=False, imu=False, odom=False, stride=None, loop_cap=None, radius=None, time_gap=None,
                         probe_at=[])
    assert {k: getattr(args, k) for k in tool_defaults} == tool_defaults
    assert args.json_out == "CAMPUS_RUN_torch.json" and args.out == "out_campus_torch"
    assert not {Path(args.json_out).parts[0], Path(args.out).parts[0]} & REFERENCE_OUTPUTS
    ignored = (ROOT / ".gitignore").read_text().split()
    assert f"{args.out}/" in ignored
