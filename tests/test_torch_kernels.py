"""The kernel wrappers of the port: which path a tensor takes, the input
checks, and (on an NVIDIA GPU only) each CUDA kernel against its plain
PyTorch twin.

This file imports no JAX, so the card's machine runs it as it is:

    python -m pytest --noconftest -o addopts="" -q tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from lego_loam_torch import cuda
from lego_loam_torch.ops.knn import k2_split, top5_l2, top5_l2_plain
from lego_loam_torch.ops.segmentation import _hook_step, k1_layout, label_prop, label_prop_plain

H, W = 16, 1800
ROWS = [16, 32, 64]  # the sensor presets' scan heights
# K2 at the main path's shapes (odometry corner/surf, mapping corner/surf)
# and at its edge cases: Q not a multiple of 4 per lane or of 128 per
# block, T below 5, T not a multiple of the 256-target tile.
K2_SHAPES = [(1024, 1024), (2048, 4256), (1024, 8192), (4096, 32768), (301, 1000), (7, 3), (130, 257)]


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _cc_masks(batch, seed, device="cpu", H=H):
    """Symmetric 4-neighbour masks of random blobs on full-width scans
    (columns wrap), as the range image's angle test makes them."""
    g = torch.Generator().manual_seed(seed)
    cand = torch.rand((batch, H, W), generator=g) < 0.8
    right = cand & torch.roll(cand, -1, dims=-1) & (torch.rand((batch, H, W), generator=g) < 0.7)
    left = torch.roll(right, 1, dims=-1)
    vpair = cand[:, 1:] & cand[:, :-1] & (torch.rand((batch, H - 1, W), generator=g) < 0.5)
    up = torch.zeros_like(cand)
    up[:, 1:] = vpair
    down = torch.zeros_like(cand)
    down[:, :-1] = vpair
    return [m.to(device).contiguous() for m in (left, right, up, down, cand)]


def _comb(device="cpu", H=H):
    """One path through every pixel of a full-width scan: each column joined
    top to bottom, consecutive columns joined at alternate ends (no wrap).
    A min-sweep labeller advances about one column per sweep here, so a
    fixed sweep count cannot label it (the Pallas kernel stops after 64);
    run to the fixpoint, every label is 0."""
    cand = torch.ones((1, H, W), dtype=torch.bool)
    right = torch.zeros_like(cand)
    for c in range(W - 1):
        right[0, 0 if c % 2 == 0 else H - 1, c] = True
    left = torch.roll(right, 1, dims=-1)
    up = torch.zeros_like(cand)
    up[:, 1:] = True
    down = torch.zeros_like(cand)
    down[:, :-1] = True
    return [m.to(device).contiguous() for m in (left, right, up, down, cand)]


def _knn_inputs(Q, T, seed, device="cpu"):
    rs = np.random.RandomState(seed)
    q = torch.tensor(rs.uniform(-20, 20, (Q, 3)), dtype=torch.float32, device=device)
    t = torch.tensor(rs.uniform(-20, 20, (T, 3)), dtype=torch.float32, device=device)
    m = torch.tensor(rs.rand(T) > 0.2, device=device)
    return q, t, m


def test_build_renames_each_library_into_place(tmp_path, monkeypatch):
    """`cuda.build` with a stand-in compiler: a library built is written
    to a file of its own and renamed into place (no temporary file left),
    so processes that build at once never load a half-written one; a
    failed build leaves neither file and raises."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\necho built > "$2"\n'
                    'case "$3" in *cc.cu) exit 1;; esac\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cuda, "BUILD", tmp_path / "_build")
    cuda.build(("knn",), force=True)
    assert sorted(p.name for p in (tmp_path / "_build").iterdir()) == ["libknn.so"]
    assert (tmp_path / "_build" / "libknn.so").read_text() == "built\n"
    with pytest.raises(RuntimeError, match="cc.cu"):
        cuda.build(("cc",), force=True)
    assert sorted(p.name for p in (tmp_path / "_build").iterdir()) == ["libknn.so"]


def test_cpu_tensors_take_the_twins_and_launch_nothing():
    cuda.reset_counts()
    masks = _cc_masks(1, 0)
    assert torch.equal(label_prop(*masks), label_prop_plain(*masks))
    q, t, m = _knn_inputs(64, 512, 0)
    for a, b in zip(top5_l2(q, t, m, site="test"), top5_l2_plain(q, t, m)):
        assert torch.equal(a, b)
    assert not cuda.LAUNCHES and not cuda.SITES


def test_twin_labels_are_component_minima():
    """K1's twin on random blobs: every candidate's label is the smallest
    pixel of its component, and one more round changes nothing."""
    masks = _cc_masks(2, 1)
    lab = label_prop_plain(*masks)
    for b in range(2):
        cand = masks[4][b]
        assert torch.equal(_hook_step(lab[b], *(m[b] for m in masks)), lab[b])
        idx = torch.arange(H * W, dtype=torch.int32).reshape(H, W)
        assert (lab[b][cand] <= idx[cand]).all() and (lab[b][~cand] == H * W).all()
        roots = lab[b][cand]
        assert torch.equal(lab[b].reshape(-1)[roots.long()], roots)  # each label labels itself


def test_twin_labels_a_comb_to_the_end():
    assert (label_prop_plain(*_comb()) == 0).all()


@pytest.mark.parametrize(
    "bad, error",
    [
        (lambda x: x.double(), TypeError),
        (lambda x: x[:, :2], ValueError),
        (lambda x: x.t().contiguous().t(), ValueError),
    ],
    ids=["dtype", "shape", "contiguity"],
)
def test_require_rejects(bad, error):
    x = torch.zeros((8, 3))
    cuda.require(x, "x", torch.float32, x.device, (8, 3))
    with pytest.raises(error):
        cuda.require(bad(x), "x", torch.float32, x.device, (8, 3))


@pytest.mark.parametrize("rows", ROWS)
def test_twin_labels_the_comb_at_every_preset_height(rows):
    assert (label_prop_plain(*_comb(H=rows)) == 0).all()


def test_k1_layout_fits_every_preset():
    """One cluster of 8 CTAs per scan at 16, 32 and 64 rows: 2, 4 and 8
    rows a CTA, within the 227 KB of shared memory a block may use."""
    for rows in ROWS:
        cs, per_cta, smem = k1_layout(rows, W)
        assert cs == 8 and per_cta == rows // 8 and smem <= 232448
    assert k1_layout(64, W)[2] == 8 * W * 5 + 8 * 57 * 8  # 72 KB at 64 rows


@pytest.mark.parametrize(
    "Q, T, groups",
    [(1024, 8192, 1), (300, 1000, 1), (7, 3, 1), (1024, 8192, 16), (4096, 32768, 1)],
)
def test_k2_split_covers_the_targets(Q, T, groups):
    """Splits are whole tiles, cover every target, and number at most 16."""
    tile = 2048 if groups > 1 else 256
    split_len, S = k2_split(Q, T, groups, tile, 132)
    assert split_len % tile == 0 and 1 <= S <= 16
    assert (S - 1) * split_len < T <= S * split_len


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ROWS)
def test_k1_matches_twin(gpu, rows):
    masks = _cc_masks(4, 2 + rows, gpu, H=rows)
    cuda.reset_counts()
    out = label_prop(*masks)
    assert cuda.LAUNCHES["cc_label_prop"] == 1
    ref = label_prop_plain(*masks)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert (label_prop(*_comb(gpu, H=rows)) == 0).all()


def _check_k2(q, t, m, groups=1, exact_ties=False):
    cuda.reset_counts()
    idx, d2 = top5_l2(q, t, m, groups=groups, site="test")
    assert cuda.SITES["knn_top5@test"] == 1
    ridx, rd2 = top5_l2_plain(q, t, m, groups=groups)
    torch.cuda.synchronize()
    # the same float32 formula with the sums in another order
    finite = rd2 < 1e29
    assert torch.equal(d2 < 1e29, finite) and torch.equal(idx < 0, ridx < 0)
    if finite.any():
        assert float((d2 - rd2).abs()[finite].max()) <= 1e-3
    if exact_ties:
        assert torch.equal(idx, ridx)
    assert float((idx == ridx).float().mean()) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("Q, T", K2_SHAPES)
def test_k2_matches_twin(gpu, Q, T):
    _check_k2(*_knn_inputs(Q, T, Q + T, gpu))


@pytest.mark.cuda
@pytest.mark.parametrize("Q, T", [(1024, 8192), (4096, 32768)])
def test_k2_grouped_matches_twin(gpu, Q, T):
    _check_k2(*_knn_inputs(Q, T, Q + T, gpu), groups=16)


@pytest.mark.cuda
def test_k2_all_masked(gpu):
    q, t, _ = _knn_inputs(300, 1000, 5, gpu)
    idx, d2 = top5_l2(q, t, torch.zeros(1000, dtype=torch.bool, device=gpu))
    assert (idx == -1).all() and (d2 >= 1e29).all()


@pytest.mark.cuda
def test_k2_duplicate_targets_keep_the_earlier_index(gpu):
    """Integer coordinates make every d2 exact, so exact duplicates and
    equal distances are true ties: the earlier index must win, across
    tiles, warps and splits alike."""
    rs = np.random.RandomState(6)
    base = rs.randint(-4, 5, (1500, 3))
    t = np.concatenate([base, base[::-1], base])  # every point three times
    q = rs.randint(-4, 5, (700, 3))
    q[:50] = base[:50]  # queries on targets: d2 clamps at 0
    f = dict(dtype=torch.float32, device=gpu)
    m = torch.tensor(rs.rand(len(t)) > 0.1, device=gpu)
    _check_k2(torch.tensor(q, **f), torch.tensor(t, **f), m, exact_ties=True)


@pytest.mark.cuda
def test_wrappers_raise_on_bad_cuda_inputs(gpu):
    q, t, m = _knn_inputs(64, 512, 3, gpu)
    with pytest.raises(TypeError):
        top5_l2(q.double(), t, m)
    with pytest.raises(ValueError):
        top5_l2(q, t, m.cpu())
    masks = _cc_masks(1, 4, gpu)
    with pytest.raises(ValueError):
        label_prop(*masks[:4], masks[4][:, :, :100])


@pytest.mark.cuda
def test_native_library_builds_from_source_on_the_card_host(gpu):
    """g++ builds native/lego_native.cpp here too (the tracked library was
    built with -march=native and is never loaded); prep_cloud equals its
    twin."""
    from lego_loam_torch import native

    native.build(force=True)
    assert native.available()
    pts = np.random.RandomState(0).randn(500, 3).astype(np.float32)
    pts[7, 1] = np.nan
    for a, b in zip(native.prep_cloud(pts, 600), native.prep_cloud_plain(pts, 600)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_cli_runs_on_the_gpu(gpu, tmp_path):
    """`python -m lego_loam_torch.run` on the card by default: three
    synthetic scans at full width, both kernels launched."""
    import json
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    r = subprocess.run(
        [sys.executable, "-m", "lego_loam_torch.run", "--synthetic", "3", "--out", str(tmp_path), "--profile"],
        cwd=root, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    prof = json.loads((tmp_path / "profile.json").read_text())
    assert prof["device"] == torch.cuda.get_device_name(0)
    assert prof["launches"].get("cc_label_prop", 0) >= 3 and prof["launches"].get("knn_top5", 0) > 0
    pose = np.loadtxt(tmp_path / "pose.txt")
    assert pose.shape == (3, 7) and np.isfinite(pose).all()


@pytest.mark.cuda
def test_eskf_on_the_card_matches_the_cpu(gpu, tmp_path):
    from lego_loam_torch import eskf as E
    from lego_loam_torch.io import eskf_data
    from lego_loam_torch.io.synthetic import synth_eskf_fixture

    synth_eskf_fixture(str(tmp_path), n=301, steer=0.05, seed=1)
    d = eskf_data.load(str(tmp_path))
    qn = eskf_data.quaternion_noise_scale(d["lidar_rpy_gt"], d["lidar_rpy"])
    args = [d[k][:300] for k in ("acc_mea", "omega_mea")] + [d["lidar_pos"], d["lidar_rpy"]] + \
        [d[k][:300] for k in ("vel_count", "steer_count")]
    out = {}
    for dev in ("cpu", gpu):
        s0 = E.init_state(d["gt_pos"][0], d["gt_vel"][0], d["gt_att"][0], device=dev)
        out[str(dev)] = E.run_eskf(*args, s0, qn)[1]["pos"].cpu().numpy()
    np.testing.assert_allclose(out[str(gpu)], out["cpu"], atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_voxel_centroids_are_reproducible_on_the_card(gpu):
    """The voxel sums are a segmented reduction over sorted runs, not float
    atomics: the same cloud gives the same bits on every call, and the
    CPU's bits."""
    from lego_loam_torch.ops.voxel import voxel_downsample_masked

    g = torch.Generator().manual_seed(0)
    xyz = torch.rand(30000, 3, generator=g) * 100 - 50
    m = torch.rand(30000, generator=g) > 0.2
    cpu = voxel_downsample_masked(xyz, m, 0.2, 50.0, radial_pack=True)
    for _ in range(3):
        card = voxel_downsample_masked(xyz.to(gpu), m.to(gpu), 0.2, 50.0, radial_pack=True)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu))
