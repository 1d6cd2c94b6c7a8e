"""The port's config, state conversion and import boundary."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from lego_loam_tpu import config as ref_config
from lego_loam_torch import config as port_config
from lego_loam_torch.convert import (
    backend_state_from_reference,
    config_from_reference,
    map_state_from_reference,
    odometry_state_from_reference,
    to_numpy,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("preset", ["VLP-16", "VLP-32c", "HDL-64E"])
def test_presets_equal(preset):
    ref = ref_config.get_config(preset)
    ours = port_config.get_config(preset)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert dataclasses.asdict(config_from_reference(ref)) == dataclasses.asdict(ref)
    assert ours.laser.ang_res_x == ref.laser.ang_res_x
    assert ours.features.surf_ground_cap == ref.features.surf_ground_cap


def test_states_round_trip():
    """Reference states convert into the port's types and back unchanged."""
    from lego_loam_tpu.backend import init_backend_state
    from lego_loam_tpu.frontend import init_odometry_state

    from _torch_parity import small_ref_cfg

    cfg = small_ref_cfg(max_keyframes=8)
    backend = init_backend_state(cfg)
    for ref, convert in (
        (init_odometry_state(cfg), odometry_state_from_reference),
        (backend, backend_state_from_reference),
        (backend.submap, map_state_from_reference),
    ):
        host = jax.device_get(ref)
        back = to_numpy(convert(host, "cpu"))
        flat_ref = jax.tree_util.tree_leaves_with_path(host)
        assert len(flat_ref) == len(jax.tree_util.tree_leaves(back))
        for path, leaf in flat_ref:
            node = back
            for key in path:
                node = node[key.name]
            np.testing.assert_array_equal(node, np.asarray(leaf, node.dtype))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_never_imports_jax():
    """Neither the port, chip_smoke.py nor the rank programs of the
    multi-rank tests (tests/_torch_ranks.py) import jax, flax or
    lego_loam_tpu, in the source or at run time."""
    files = sorted((ROOT / "lego_loam_torch").rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "tests" / "_torch_ranks.py"]
    assert len(files) > 15
    for f in files:
        bad = [m for m in _imports(f) if m.split(".")[0] in ("jax", "flax", "lego_loam_tpu")]
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"
    code = (
        "import sys, lego_loam_torch.pipeline, lego_loam_torch.convert, chip_smoke; "
        "import lego_loam_torch.run, lego_loam_torch.checkpoint, lego_loam_torch.relocalize, "
        "lego_loam_torch.native, lego_loam_torch.eskf, lego_loam_torch.io.kitti, lego_loam_torch.io.rosbag2, "
        "lego_loam_torch.io.eskf_data, lego_loam_torch.distributed, lego_loam_torch.launch, "
        "lego_loam_torch.ops.hashgrid, lego_loam_torch.campus_run, lego_loam_torch.bench, "
        "lego_loam_torch.weak_scaling, lego_loam_torch.diag_campus; sys.path.insert(0, 'tests'); import _torch_ranks; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'lego_loam_tpu')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


@pytest.mark.parametrize("program", ["bench", "weak_scaling", "diag_campus"])
def test_programs_refuse_without_a_gpu(program):
    """Without a visible GPU and without --device cpu, each program exits 2
    with a message naming the flag, as run.py does."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", f"lego_loam_torch.{program}"], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 2 and "--device cpu" in r.stderr and not r.stdout
