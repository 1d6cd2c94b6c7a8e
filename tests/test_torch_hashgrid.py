"""Parity of the port's voxel-hash k-NN (`lego_loam_torch/ops/hashgrid.py`)
with the reference's, on tests/test_hashgrid.py's two cases: the table
equal slot for slot; `query_knn` through the reference's own grid (converted
by `hashgrid_from_reference`) equal in indices and within 1e-5 in d2; and
the port alone against brute force as that file holds the reference: 5-NN
recall > 0.98 where the true 5th neighbour lies within the 1 m cell, and
no masked point returned."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lego_loam_tpu.ops import hashgrid as RH
from lego_loam_torch.convert import hashgrid_from_reference
from lego_loam_torch.ops import hashgrid as H
from lego_loam_torch.ops.knn import pairwise_sqdist


def _case(name):
    """(points, mask, queries) of tests/test_hashgrid.py's case."""
    if name == "bruteforce":
        rs = np.random.RandomState(0)
        T, Q = 20000, 300
        pts = rs.uniform(-8, 8, (T, 3)).astype(np.float32)
        mask = np.ones(T, bool)
        mask[::11] = False
        q = (pts[rs.choice(T, Q)] + rs.randn(Q, 3) * 0.2).astype(np.float32)
    else:  # masked: only 10 of 500 points valid
        rs = np.random.RandomState(1)
        pts = rs.uniform(-5, 5, (500, 3)).astype(np.float32)
        mask = np.zeros(500, bool)
        mask[:10] = True
        q = pts[:20].copy()
    return pts, mask, q


CASES = ["bruteforce", "masked"]


@pytest.mark.parametrize("name", CASES)
def test_table_equals_reference(name):
    pts, mask, _ = _case(name)
    ref = RH.build_grid(jnp.asarray(pts), jnp.asarray(mask), 1.0)
    ours = H.build_grid(torch.from_numpy(pts), torch.from_numpy(mask), 1.0)
    np.testing.assert_array_equal(ours.table.numpy(), np.asarray(ref.table))
    assert ours.table.dtype == torch.int32 and ours.cell == ref.cell


def test_bucket_hash_wraps_as_uint32():
    """Negative and large cell coordinates hash as the reference's uint32
    arithmetic does."""
    rs = np.random.RandomState(2)
    v = rs.randint(-2 ** 31, 2 ** 31 - 1, (4096, 3)).astype(np.int32)
    v[:27] = np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1], indexing="ij"), -1).reshape(-1, 3)
    np.testing.assert_array_equal(H._bucket_of(torch.from_numpy(v), 1 << 17).numpy(),
                                  np.asarray(RH._bucket_of(jnp.asarray(v), 1 << 17)))


@pytest.mark.parametrize("name", CASES)
def test_query_matches_reference(name):
    pts, mask, q = _case(name)
    grid = RH.build_grid(jnp.asarray(pts), jnp.asarray(mask), 1.0)
    ref_i, ref_d = RH.query_knn(grid, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(q), jnp.ones(len(q), bool), 5)
    idx, d2 = H.query_knn(hashgrid_from_reference(jax.device_get(grid), "cpu"), torch.from_numpy(pts),
                          torch.from_numpy(mask), torch.from_numpy(q), torch.ones(len(q), dtype=torch.bool), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(d2.numpy(), np.asarray(ref_d), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", CASES)
def test_recall_and_mask(name):
    pts, mask, q = _case(name)
    P, M, Qt = torch.from_numpy(pts), torch.from_numpy(mask), torch.from_numpy(q)
    idx, d2 = H.query_knn(H.build_grid(P, M, 1.0), P, M, Qt, torch.ones(len(q), dtype=torch.bool), 5)
    idx, d2 = idx.numpy(), d2.numpy()
    ok = idx >= 0
    assert mask[idx[ok]].all()  # never a masked point
    if name == "bruteforce":
        bf = pairwise_sqdist(Qt, P).numpy()
        bf[:, ~mask] = 1e30
        bf5 = np.sort(bf, axis=1)[:, :5]
        gate = bf5[:, -1] < 1.0
        assert gate.sum() > 50
        recall = (np.abs(d2[gate] - bf5[gate]) < 1e-3).all(axis=1).mean()
        assert recall > 0.98, recall
        assert (idx[gate] >= 0).all()
