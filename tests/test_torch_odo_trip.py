"""The scan-to-scan odometry's trip kernel (`csrc/odo.cu`) against its plain
twin (`odometry._solve_stage_plain`).

On the CPU: a CPU tensor takes the twin and launches nothing, the stage
refuses inputs the kernel does not take, and the launchers' C argument
lists match `cuda._SIGNATURES` and the kernel's settings `_odo_params`. On
an NVIDIA GPU only, on the feature clouds of real frames of a swept drive:
the fit cache equals the twin's bit for bit, each stage (3 and 6 DOFs, warm
and cold starts, converging and never converging) agrees with the twin,
runs repeat bit for bit in both `sync_free` modes and inside a CUDA graph.

This file imports no JAX, so the card's machine runs it as it is:

    python -m pytest --noconftest -o addopts="" -q tests/test_torch_odo_trip.py
"""

import ctypes
import dataclasses
import math
import re

import numpy as np
import pytest
import torch

from lego_loam_torch import cuda, frontend
from lego_loam_torch import odometry as O
from lego_loam_torch.config import vlp16
from lego_loam_torch.io.synthetic import straight_trajectory, swept_scan_sequence
from lego_loam_torch.ops.knn import top5_l2
from lego_loam_torch.pipeline import LegoLoamPipeline
from lego_loam_torch.types import FeatureCloud, ScanFeatures

_C_TYPES = {"int": ctypes.c_int, "void*": ctypes.c_void_p}


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the trip kernel has no CPU mode")
    return torch.device("cuda", 0)


def drive_cfg():
    """The VLP-16 preset, loop closure off, a small store, one device."""
    cfg = vlp16()
    return dataclasses.replace(
        cfg,
        mapping=dataclasses.replace(cfg.mapping, enable_loop_closure=False, max_keyframes=32),
        distributed=dataclasses.replace(cfg.distributed, shard_backend=False, use_sharded_posegraph=False),
    )


@pytest.fixture(scope="module")
def frames():
    """The inputs of `two_step_odometry` on frames 1-4 of a swept drive with
    a turn, recorded from the port on the CPU (the twin)."""
    cfg = drive_cfg()
    scans = swept_scan_sequence(straight_trajectory(5, speed=0.3, yaw_rate=0.02), cfg, noise=0.005)
    rec, orig = [], frontend.two_step_odometry

    def recording(*args):  # the state is written in place: keep copies
        rec.append(tuple(on(x, "cpu", copy=True) for x in args[:5]))
        return orig(*args)

    frontend.two_step_odometry = recording
    try:
        LegoLoamPipeline(cfg, device="cpu").run(list(scans))
    finally:
        frontend.two_step_odometry = orig
    return cfg, rec


def on(x, dev, copy=False):
    """A tensor or a dataclass of tensors on `dev`."""
    return x.to(dev, copy=copy) if isinstance(x, torch.Tensor) else type(x)(**{
        f.name: on(getattr(x, f.name), dev, copy) for f in dataclasses.fields(x)})


def stage_inputs(frame, kind, dev, cold=False):
    feats, last_corner, last_surf, M_R, M_t = frame
    if cold:
        M_R, M_t = torch.eye(3), torch.zeros(3)
    query, target = (feats.surf_flat, last_surf) if kind == "surf" else (feats.corner_sharp, last_corner)
    return on(M_R, dev), on(M_t, dev), on(query, dev), on(target, dev)


def dofs(kind, full):
    return O.FULL_DOFS if full else (O.SURF_DOFS if kind == "surf" else O.CORNER_DOFS)


def random_cloud(n, seed):
    g = torch.Generator().manual_seed(seed)
    return FeatureCloud(xyz=torch.rand((n, 3), generator=g) * 20 - 10, ring=torch.zeros(n, dtype=torch.int32),
                        rel_time=torch.rand(n, generator=g), mask=torch.rand(n, generator=g) > 0.2)


# ---- CPU


@pytest.mark.parametrize("sync_free", [False, True])
@pytest.mark.parametrize("full_dof", [False, True])
def test_cpu_tensors_take_the_twin(monkeypatch, sync_free, full_dof):
    """two_step_odometry on CPU tensors runs the plain twin, unchanged, and
    launches nothing."""
    cfg = drive_cfg()
    cfg = dataclasses.replace(cfg, odometry=dataclasses.replace(cfg.odometry, full_dof_odometry=full_dof,
                                                                max_iterations=3, accel_cap=0.0))

    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the trip kernel")

    monkeypatch.setattr(O, "_solve_stage_cuda", refuse)
    flat, sharp, ground, less = (random_cloud(n, s) for n, s in ((64, 1), (32, 2), (96, 3), (48, 4)))
    feats = ScanFeatures(corner_sharp=sharp, corner_less_sharp=less, surf_flat=flat, surf_less_flat=ground,
                         surf_ground=ground)
    M_R, M_t = torch.eye(3), torch.tensor([0.1, 0.0, 0.0])
    cuda.reset_counts()
    R, t, trips = O.two_step_odometry(feats, less, ground, M_R, M_t, cfg, sync_free)
    assert not cuda.LAUNCHES and not cuda.SITES
    Rs, ts, us = O._solve_stage_plain(M_R, M_t, flat, ground, "surf", dofs("surf", full_dof), cfg, sync_free)
    Rc, tc, uc = O._solve_stage_plain(Rs, ts, sharp, less, "corner", dofs("corner", full_dof), cfg, sync_free)
    assert torch.equal(R, Rc) and torch.equal(t, tc) and int(trips) == int(us) + int(uc)


def c_launchers(name):
    """{function: [ctypes argument types]} of the `extern "C" int` launchers
    in csrc/<name>.cu."""
    src = (cuda.CSRC / f"{name}.cu").read_text()
    out = {}
    for fn, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        types = []
        for arg in args.split(","):
            words = arg.replace("*", " * ").split()[:-1]  # drop the parameter's name
            words = [w for w in words if w != "const"]
            types.append(_C_TYPES["void*" if "*" in words else " ".join(words)])
        out[fn] = types
    return out


@pytest.mark.parametrize("name", cuda.SOURCES)
def test_launcher_signatures_match_the_sources(name):
    """ctypes passes each argument as `_SIGNATURES` says: a pointer as a
    64-bit pointer, an int as an int. A mismatch cuts a pointer or shifts
    every later argument, and nothing checks it at the call."""
    assert c_launchers(name) == cuda._SIGNATURES[name]


def test_odo_params_follow_the_kernel_struct():
    """`_odo_params` gives one float for each field of the kernel's Params,
    in its order, and the float32 values the twin's scalars round to."""
    src = (cuda.CSRC / "odo.cu").read_text()
    body = re.search(r"struct Params \{(.*?)\};", src, re.S).group(1)
    fields = re.sub(r"\s+", "", body.replace("float", "").replace(";", "")).split(",")
    cfg = drive_cfg()
    for kind in O._KINDS:
        prm = O._odo_params(kind, cfg)
        assert len(prm) == len(fields) == 18
        vals = dict(zip(fields, prm))
        o = cfg.odometry
        assert vals["min_corr"] == o.min_correspondences
        assert vals["refresh_thr"] == np.float32(1.0 + 2.0 * math.cos(o.refresh_rot_deg * math.pi / 180.0))
        assert vals["max_d2"] == np.float32((o.corner_nn_max_dist if kind == "corner" else o.surf_nn_max_dist) ** 2)


@pytest.mark.parametrize("bad, error", [
    (lambda a: {**a, "M_R": a["M_R"].double()}, TypeError),
    (lambda a: {**a, "M_t": torch.zeros(4)}, ValueError),
    (lambda a: {**a, "query": a["query"].replace(rel_time=a["query"].rel_time.double())}, TypeError),
    (lambda a: {**a, "target": a["target"].replace(mask=a["target"].mask[:-1])}, ValueError),
    (lambda a: {**a, "dof_mask": (True,) * 4 + (False,) * 2}, ValueError),
    (lambda a: {**a, "kind": "ground"}, ValueError),
])
def test_stage_refuses_what_the_kernel_does_not_take(bad, error):
    """The launcher's checks run before anything reaches the card."""
    args = dict(M_R=torch.eye(3), M_t=torch.zeros(3), query=random_cloud(16, 5), target=random_cloud(32, 6),
                kind="surf", dof_mask=O.SURF_DOFS, cfg=drive_cfg())
    with pytest.raises(error):
        O._OdoStage(**bad(args))


# ---- the card


def twin_fit(kind, fit_fn, target, idx, ok, cfg):
    """The twin's fit of K2's lists with the eval's gates applied, in the
    kernel's cache layout (gated ok in column 7)."""
    o = cfg.odometry
    fit = fit_fn(target.xyz[idx.clamp(min=0).long()], ok)
    if kind == "corner":
        cx, cy, cz, vx, vy, vz, ratio, ok = fit
        return torch.stack([cx, cy, cz, vx, vy, vz], 1), ok & (ratio > o.corner_line_ratio)
    gx, gy, gz, d_off, max_dev, ok = fit
    ok = ok & (max_dev < o.surf_plane_tol)
    if o.surf_normal_min_z > 0:
        ok = ok & (gz.abs() >= o.surf_normal_min_z)
    return torch.stack([gx, gy, gz, d_off], 1), ok


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["surf", "corner"])
def test_fit_cache_is_the_twins_bit_for_bit(gpu, frames, kind):
    """Given the same K2 lists, the kernel's line and plane fits and gates
    are the twin's as PyTorch computes them on the card, bit for bit: the
    plane normals of nearly collinear neighbours are ill-conditioned, and a
    last-bit difference there moves the step by tenths of a millimetre."""
    cfg, rec = frames
    search_fn, fit_fn, _ = O._STAGES[kind]
    for frame in rec:
        M_R, M_t, query, target = stage_inputs(frame, kind, gpu)
        stage = O._OdoStage(M_R, M_t, query, target, kind, dofs(kind, False), cfg)
        idx, d5 = top5_l2(stage.qw, target.xyz, target.mask)
        stage.trip(idx, d5)
        ok = query.mask & (d5[:, 4] < (cfg.odometry.corner_nn_max_dist if kind == "corner"
                                       else cfg.odometry.surf_nn_max_dist) ** 2)
        want, want_ok = twin_fit(kind, fit_fn, target, idx, ok, cfg)
        torch.cuda.synchronize()
        got = stage.fit[:, :want.shape[1]]
        assert torch.equal(stage.fit[:, 7] != 0, want_ok)
        assert torch.equal(got[want_ok], want[want_ok]), (got - want)[want_ok].abs().max()


CASES = [  # (kind, full DOFs, cold start, never converges)
    ("surf", False, False, False), ("corner", False, False, False), ("surf", False, True, False),
    ("corner", False, True, False), ("surf", True, False, False), ("corner", True, False, False),
    ("surf", False, False, True), ("corner", False, False, True), ("corner", True, True, True),
]


def case_cfg(cfg, full, never):
    o = dataclasses.replace(cfg.odometry, full_dof_odometry=full, **({"rot_converge_deg": 0.0} if never else {}))
    return dataclasses.replace(cfg, odometry=o)


@pytest.mark.cuda
@pytest.mark.parametrize("kind, full, cold, never", CASES)
def test_stage_matches_the_twin(gpu, frames, kind, full, cold, never):
    """Each stage against the twin on the card, host-branching both: the
    same useful trips, and the pose within 2e-5 (m, and per matrix entry):
    the fits are the twin's bit for bit, but H, g and the robust weights'
    mean are summed in another order and the warp's log goes through
    another 3x3 inverse, so the iterates part by float32 roundings, which
    a K2 near-tie can carry into one point's fit (the largest gap seen:
    6e-8 on these frames, 2.7e-6 on chip_smoke's; the benchmark holds the
    odometry to 1e-4 m)."""
    cfg, rec = frames
    cfg = case_cfg(cfg, full, never)
    worst = 0.0
    for frame in rec:
        M_R, M_t, query, target = stage_inputs(frame, kind, gpu, cold)
        R, t, trips = O._solve_stage_cuda(M_R, M_t, query, target, kind, dofs(kind, full), cfg, False)
        Rp, tp, tripsp = O._solve_stage_plain(M_R, M_t, query, target, kind, dofs(kind, full), cfg, False)
        assert int(trips) == int(tripsp)
        if never:
            assert int(trips) == cfg.odometry.max_iterations
        worst = max(worst, float((R - Rp).abs().max()), float((t - tp).abs().max()))
    print(f"{kind} full={full} cold={cold} never={never}: largest pose gap {worst:.3g}")
    assert worst < 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kind, full", [("surf", False), ("corner", False), ("corner", True)])
def test_runs_repeat_bit_for_bit(gpu, frames, kind, full):
    """Two runs of a stage give the same bits, in both modes and inside a
    CUDA graph (no float atomics, every sum in a fixed order); with
    `sync_free` every trip launches K2 and the trip kernel."""
    cfg, rec = frames
    cfg = case_cfg(cfg, full, False)
    M_R, M_t, query, target = stage_inputs(rec[1], kind, gpu)
    args = (M_R, M_t, query, target, kind, dofs(kind, full), cfg)
    cuda.reset_counts()
    first = O._solve_stage_cuda(*args, True)
    site = f"odometry_{kind}"
    assert cuda.SITES[f"odo_trip@{site}"] == cfg.odometry.max_iterations
    assert cuda.SITES[f"knn_top5@{site}"] == cfg.odometry.max_iterations
    again = O._solve_stage_cuda(*args, True)
    host = O._solve_stage_cuda(*args, False)
    for a, b, c in zip(first, again, host):
        assert torch.equal(a, b) and torch.equal(a, c)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        O._solve_stage_cuda(*args, True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = O._solve_stage_cuda(*args, True)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(first, out):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_stage_refuses_bad_cuda_inputs(gpu, frames):
    cfg, rec = frames
    M_R, M_t, query, target = stage_inputs(rec[0], "surf", gpu)
    with pytest.raises(ValueError):
        O._OdoStage(M_R, M_t, query, on(target, "cpu"), "surf", O.SURF_DOFS, cfg)
    with pytest.raises(ValueError):
        O._OdoStage(M_R.cpu(), M_t, query, target, "surf", O.SURF_DOFS, cfg)
    stage = O._OdoStage(M_R, M_t, query, target, "surf", O.SURF_DOFS, cfg)
    idx, d5 = top5_l2(stage.qw, target.xyz, target.mask)
    with pytest.raises(TypeError):
        stage.trip(idx.long(), d5)
    with pytest.raises(ValueError):
        stage.trip(idx[:-1], d5[:-1])
