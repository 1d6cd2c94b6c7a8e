"""Checkpoints across the two packages: the npz layout of
`lego_loam_torch.checkpoint` against `lego_loam_tpu.checkpoint`, both ways.

The reference runs 4 scans of tests/test_backend.py's `small_cfg` (with
the submap and keyframe capacities of `_torch_parity.small_ref_cfg`: the
reference takes ~6 s a scan on the CPU even so) through `process_scan` and
saves. The port loads that file and both continue over 2 more scans, the
port drawing the reference's RANSAC scores. Tolerances: the port's save of
the loaded state has the reference file's keys, shapes and dtypes and
bit-equal arrays (and the same JSON metadata); the continued map poses
agree within 1.5 cm, as tests/test_torch_pipeline.py holds the slice
(flat-feature ties, ROADMAP §3). The reference loads a file the port saved
after its own first 4 scans, and its continuation agrees with its
continuation from its own file within the same bound. The port's own
mid-run resume is in tests/test_torch_cli.py."""

import dataclasses
import json

import numpy as np
import pytest

from lego_loam_tpu import checkpoint as ref_checkpoint
from lego_loam_tpu.io.synthetic import render_scan, straight_trajectory
from lego_loam_tpu.pipeline import LegoLoamPipeline as RefPipeline
from lego_loam_torch import checkpoint
from lego_loam_torch.convert import config_from_reference
from lego_loam_torch.pipeline import LegoLoamPipeline

from _torch_parity import ref_scores
from test_backend import small_cfg

N_SAVED, N_MORE = 4, 2


def _npz(path):
    with np.load(path, allow_pickle=False) as d:
        return {k: d[k] for k in d.files}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    ref_cfg = small_cfg()
    ref_cfg = dataclasses.replace(ref_cfg, mapping=dataclasses.replace(
        ref_cfg.mapping, max_keyframes=32, max_submap_corner=4096, max_submap_surf=8192))
    cfg = config_from_reference(ref_cfg)
    poses = straight_trajectory(N_SAVED + N_MORE, speed=0.25, yaw_rate=np.deg2rad(2.0))
    scans = [render_scan(R, t, ref_cfg, noise=0.005, seed=500 + i) for i, (R, t) in enumerate(poses)]
    d = tmp_path_factory.mktemp("ckpt")

    ref = RefPipeline(ref_cfg)
    for s in scans[:N_SAVED]:
        ref.process_scan(s)
    ref_file = str(d / "ref.npz")
    ref_checkpoint.save(ref, ref_file)
    for s in scans[N_SAVED:]:
        ref.process_scan(s)
    ref.finalize()
    return ref_cfg, cfg, scans, d, ref_file, ref


def _port(cfg):
    return LegoLoamPipeline(cfg, device="cpu", ground_scores=lambda f: ref_scores(cfg, f))


def test_port_loads_reference_checkpoint(setup):
    """The port resumes from the reference's file: the same frame counter,
    a bit-equal save of the loaded state, and the next scans' map poses
    within 1.5 cm of the reference's own continuation."""
    ref_cfg, cfg, scans, d, ref_file, ref = setup
    ours = checkpoint.load(_port(cfg), ref_file)
    assert ours.frame_idx == N_SAVED

    resaved = str(d / "port_of_ref.npz")
    checkpoint.save(ours, resaved)
    a, b = _npz(ref_file), _npz(resaved)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, (k, a[k].dtype, b[k].dtype)
        if k == "__meta__":
            assert json.loads(str(a[k])) == json.loads(str(b[k]))
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    for s in scans[N_SAVED:]:
        ours.process_scan(s)
    ours.finalize()
    ref_map = np.stack(ref.trajectory["positions"])[N_SAVED:]
    np.testing.assert_allclose(np.stack(ours.trajectory["positions"]), ref_map, atol=1.5e-2, rtol=0)
    assert ours.trajectory["times"] == ref.trajectory["times"][N_SAVED:]


def test_reference_loads_port_checkpoint(setup):
    """The reference resumes from a file the port saved after its own first
    4 scans (from the same initial state and the reference's RANSAC draw):
    the reference file's keys, shapes and dtypes, and a continuation within
    1.5 cm of the reference's continuation from its own file."""
    ref_cfg, cfg, scans, d, ref_file, ref = setup
    ours = _port(cfg)
    for s in scans[:N_SAVED]:
        ours.process_scan(s)
    port_file = str(d / "port.npz")
    checkpoint.save(ours, port_file)
    a, b = _npz(ref_file), _npz(port_file)
    assert sorted(a) == sorted(b)
    assert all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype for k in a)

    back = ref_checkpoint.load(RefPipeline(ref_cfg), port_file)
    assert back.frame_idx == N_SAVED
    for s in scans[N_SAVED:]:
        back.process_scan(s)
    back.finalize()
    np.testing.assert_allclose(
        np.stack(back.trajectory["positions"]), np.stack(ref.trajectory["positions"])[N_SAVED:], atol=1.5e-2, rtol=0
    )


def test_load_refuses_other_capacity(setup):
    """A file of another configuration's capacities is refused, not cast."""
    ref_cfg, cfg, _, _, ref_file, _ = setup
    other = dataclasses.replace(cfg, mapping=dataclasses.replace(cfg.mapping, max_keyframes=64))
    with pytest.raises(ValueError, match="b0"):
        checkpoint.load(LegoLoamPipeline(other, device="cpu"), ref_file)
