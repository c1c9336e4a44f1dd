"""Sharded index on a virtual 8-device CPU mesh (SURVEY.md §4: the standard way
to test a mesh without several cards)."""
import numpy as np
import pytest

import jax

from zvdb_tpu import HNSWConfig, SearchConfig, exact_ground_truth
from zvdb_tpu.parallel.mesh import make_mesh
from zvdb_tpu.parallel.sharded import ShardedHNSW

# compile-heavy multi-device tier — deselect with -m 'not slow' (fast gate)
pytestmark = pytest.mark.slow


def recall_at_k(ids, gt_ids, k):
    return np.mean(
        [len(set(ids[r, :k]) & set(gt_ids[r, :k])) / k for r in range(ids.shape[0])]
    )


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must force 8 virtual devices"
    return make_mesh(n_shards=8)


def test_sharded_build_and_search(rng, mesh8):
    n, d, k = 8000, 32, 10
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((50, d)).astype(np.float32)
    idx = ShardedHNSW(
        HNSWConfig(dim=d, m=12, ef_construction=64, build_batch=256), mesh=mesh8
    )
    idx.build(x)
    assert len(idx) == n
    _, gt = exact_ground_truth(x, q, k)
    s, ids = idx.search(q, k, ef_search=64)
    ids = np.asarray(ids)
    assert ids.shape == (50, k)
    # global external ids: all in range, no duplicates per row
    assert (ids >= 0).all() and (ids < n).all()
    for r in range(ids.shape[0]):
        assert len(set(ids[r])) == k
    r = recall_at_k(ids, gt, k)
    assert r >= 0.85, f"sharded recall {r:.3f}"
    # merged scores are sorted ascending (l2)
    s = np.asarray(s)
    assert (np.diff(s, axis=1) >= -1e-5).all()


def test_sharded_matches_per_shard_truth(rng, mesh8):
    # every returned id must come from somewhere: scores must equal true
    # squared distances to the returned global ids
    n, d, k = 4000, 16, 5
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((8, d)).astype(np.float32)
    idx = ShardedHNSW(
        HNSWConfig(dim=d, m=8, ef_construction=48, build_batch=256), mesh=mesh8
    )
    idx.build(x)
    s, ids = idx.search(q, k, ef_search=48)
    s, ids = np.asarray(s), np.asarray(ids)
    true = ((q[:, None, :] - x[ids]) ** 2).sum(-1)
    np.testing.assert_allclose(s, true, rtol=1e-3, atol=1e-2)


def test_sharded_uneven_and_empty(rng, mesh8):
    # n not divisible by shards; some shards nearly empty
    n, d, k = 37, 8, 40
    x = rng.standard_normal((n, d)).astype(np.float32)
    idx = ShardedHNSW(HNSWConfig(dim=d, m=4, ef_construction=16, build_batch=16),
                      mesh=mesh8)
    idx.build(x)
    s, ids = idx.search(x[:3], k, ef_search=64)
    ids = np.asarray(ids)
    # k > n: exactly n valid results per row
    assert ((ids >= 0).sum(axis=1) == n).all()
    # self-hit first
    assert (ids[:, 0] == np.arange(3)).all()


def test_empty_sharded(mesh8):
    idx = ShardedHNSW(HNSWConfig(dim=8), mesh=mesh8)
    s, ids = idx.search(np.zeros((2, 8), np.float32), 3)
    assert (np.asarray(ids) == -1).all()
