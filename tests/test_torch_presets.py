"""Parity of the port with the reference at the 32- and 64-row presets and on
exact ties: the connected components of rendered `vlp32c()` and `hdl64e()`
scans (the rows K1 now splits over a cluster on the card), and the 5-NN
twin's tie rule on duplicate targets (the rule K2 keeps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu import config as ref_config
from lego_loam_tpu.ops import ground as RG
from lego_loam_tpu.ops import projection as RP
from lego_loam_tpu.ops import segmentation as RS
from lego_loam_tpu.ops.knn import pairwise_sqdist as ref_sqdist
from lego_loam_tpu.ops.knn import top_k_sqdist
from lego_loam_torch.ops import segmentation as PS
from lego_loam_torch.ops.knn import top5_l2_plain
from lego_loam_torch.types import ScanGrid

from _torch_parity import pair, port, scene


@pytest.fixture(scope="module", params=["vlp32c", "hdl64e"])
def grounded(request):
    """A rendered full-width scan of the preset, ground-labelled by the
    reference: (reference config, port config, reference grid)."""
    ref, cfg = pair(getattr(ref_config, request.param)())
    packed = RP.host_pack_range_image(scene(2, cfg), ref)
    grid = RP.grid_from_range_image(*[jnp.asarray(p) for p in packed], ref)
    key = jax.random.PRNGKey(3)
    return ref, cfg, jax.jit(lambda g: RG.apply_ground(g, ref, key))(grid)


def test_converged_labels_bit_equal(grounded):
    ref, cfg, ref_grid = grounded
    labels, cand = PS.converged_labels(port(ref_grid, ScanGrid), cfg)
    ref_labels, ref_cand = jax.jit(lambda g: RS.converged_labels(g, ref))(ref_grid)
    np.testing.assert_array_equal(np.asarray(ref_cand), cand.numpy())
    np.testing.assert_array_equal(np.asarray(ref_labels), labels.numpy())
    H = cfg.laser.num_vertical_scans
    assert labels.shape == (H, 1800)
    # a real scene: many components, some spanning several rows
    roots = labels[cand]
    assert roots.unique().numel() > 20
    rows_of = torch.div(roots, 1800, rounding_mode="floor")
    own_row = torch.div(torch.nonzero(cand.reshape(-1)).flatten(), 1800, rounding_mode="floor")
    assert (rows_of != own_row).any()


def test_k1_cluster_holds_every_preset(grounded):
    """The rows of the preset's scan fit K1's cluster layout."""
    _, cfg, _ = grounded
    cs, rows, smem = PS.k1_layout(cfg.laser.num_vertical_scans, cfg.laser.num_horizontal_scans)
    assert cs * rows == cfg.laser.num_vertical_scans and smem <= 232448


def test_connectivity_masks_are_symmetric(grounded):
    """K1 reads only `right` and `down` on the card, the twin all four
    masks: they agree because `_connectivity` makes the masks symmetric
    (left is right rolled by one column, up is down shifted by one row)."""
    _, cfg, ref_grid = grounded
    grid = port(ref_grid, ScanGrid)
    cand = grid.valid & (grid.ground != 1)
    left, right, up, down = PS._connectivity(grid, cand, cfg)
    assert right.any() and down.any()
    assert torch.equal(left, torch.roll(right, 1, dims=-1))
    assert torch.equal(up[1:], down[:-1])
    assert not up[0].any() and not down[-1].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_top5_twin_keeps_the_earlier_duplicate(seed):
    """Exact duplicate targets and integer coordinates (so every d2 is exact
    and equal distances are true ties): the twin matches the reference's
    exact k-NN (`top_k_sqdist`, which keeps the lower index on ties) index
    for index, and each tie goes to the earlier copy."""
    rs = np.random.RandomState(seed)
    base = rs.randint(-4, 5, (700, 3)).astype(np.float32)
    t = np.concatenate([base, base[::-1], base])
    q = rs.randint(-4, 5, (300, 3)).astype(np.float32)
    q[:40] = base[:40]  # queries on targets: three copies at d2 = 0
    mask = rs.rand(len(t)) > 0.1
    ref_i, ref_d = top_k_sqdist(ref_sqdist(jnp.asarray(q), jnp.asarray(t)), jnp.asarray(mask), 5)
    idx, d2 = top5_l2_plain(torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(mask))
    np.testing.assert_array_equal(np.asarray(ref_d), d2.numpy())
    np.testing.assert_array_equal(np.asarray(ref_i), idx.numpy())
    # on a target: its unmasked copies come first, earliest first
    for r in range(40):
        copies = np.flatnonzero(mask & (t == q[r]).all(1))[:5]
        assert len(copies) and idx[r, : len(copies)].tolist() == copies.tolist()
