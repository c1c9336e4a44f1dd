"""Cluster-sharded IVF-PQ on the virtual 8-device mesh.

Mirrors tests/test_sharded_ivf.py for the scale-tier engine: recall floor
at a matched global probe budget, global-id/merge invariants, incremental
insert routing, delete + filtered-search semantics, get()/save/load, and
compact. The grouped ADC scan is the single-device engine's
(ops/pq_grouped.py)."""
import os

import numpy as np
import pytest

import jax

from zvdb_tpu import IVFPQConfig, exact_ground_truth
from zvdb_tpu.parallel.mesh import make_mesh
from zvdb_tpu.parallel.sharded_ivfpq import ShardedIVFPQ

# compile-heavy multi-device tier — deselect with -m 'not slow' (fast gate)
pytestmark = pytest.mark.slow


def recall_at_k(ids, gt, k):
    return np.mean(
        [len(set(ids[r, :k]) & set(gt[r, :k])) / k for r in range(ids.shape[0])]
    )


def clustered(n, d, seed, nc=50):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nc, d)).astype(np.float32)
    a = rng.integers(0, nc, n)
    return (centers[a] + 0.15 * rng.standard_normal((n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8
    return make_mesh(n_shards=8)


CFG = dict(n_sub=16, nprobe=16, refine="int16", rerank=12,
           train_sample=4096)


def test_sharded_ivfpq_recall(rng, mesh8):
    n, d, k = 16000, 64, 10
    x = clustered(n, d, seed=1)
    q = (x[rng.integers(0, n, 128)]
         + 0.05 * rng.standard_normal((128, d))).astype(np.float32)
    _, gt = exact_ground_truth(x, q, k)
    idx = ShardedIVFPQ(IVFPQConfig(dim=d, **CFG), mesh=mesh8)
    idx.build(x)
    assert len(idx) == n
    s, ids = idx.search(q, k)
    ids = np.asarray(ids)
    r = recall_at_k(ids, gt, k)
    assert r >= 0.90, f"sharded ivfpq recall {r:.3f}"
    # global external ids, no duplicates
    assert (ids >= 0).all() and (ids < n).all()
    for row in ids:
        assert len(set(row.tolist())) == k
    # merged scores sorted ascending (l2)
    s = np.asarray(s)
    assert (np.diff(s, axis=1) >= -1e-5).all()


def test_sharded_ivfpq_empty(mesh8):
    idx = ShardedIVFPQ(IVFPQConfig(dim=16, n_sub=8, n_clusters=8), mesh=mesh8)
    s, ids = idx.search(np.zeros((2, 16), np.float32), 3)
    assert (np.asarray(ids) == -1).all()


def test_sharded_ivfpq_add_routes_to_shards(rng, mesh8):
    n, d, k = 8000, 64, 5
    x = clustered(n, d, seed=2)
    idx = ShardedIVFPQ(IVFPQConfig(dim=d, **CFG), mesh=mesh8)
    idx.build(x[: n // 2])
    idx.add(x[n // 2:])
    assert len(idx) == n
    # inserted rows are findable by id and by search
    q = x[n // 2: n // 2 + 64]
    _, ids = idx.search(q, k)
    ids = np.asarray(ids)
    hit = np.mean([n // 2 + i in set(ids[i].tolist())
                   for i in range(q.shape[0])])
    assert hit >= 0.9, f"self-hit after add {hit:.3f}"
    got = idx.get(np.arange(n // 2, n // 2 + 8))
    err = np.abs(got - x[n // 2: n // 2 + 8]).max()
    assert err < 0.05, f"refine-store roundtrip err {err}"  # int16 quantized


def test_sharded_ivfpq_delete_and_filter(rng, mesh8):
    n, d, k = 8000, 64, 5
    x = clustered(n, d, seed=3)
    idx = ShardedIVFPQ(IVFPQConfig(dim=d, **CFG), mesh=mesh8)
    idx.build(x)
    q = x[:64]
    _, ids0 = idx.search(q, 1)
    victims = np.unique(np.asarray(ids0)[:, 0])
    assert idx.remove(victims) == victims.size
    assert len(idx) == n - victims.size
    _, ids1 = idx.search(q, k)
    assert not np.isin(np.asarray(ids1), victims).any()

    # filtered search (exact masked scan): only allowed ids surface, and
    # results match the brute-force masked oracle
    allowed = np.zeros(n, bool)
    allowed[: n // 10] = True
    sf, idf = idx.search(q, k, allowed=allowed)
    idf = np.asarray(idf)
    assert np.isin(idf[idf >= 0], np.flatnonzero(allowed)).all()
    xa = x[: n // 10]
    d2 = ((q[:, None, :] - xa[None, :, :]) ** 2).sum(-1)
    d2[:, victims[victims < n // 10]] = np.inf   # deleted rows stay excluded
    gt_f = np.argsort(d2, axis=1)[:, :k]
    r = recall_at_k(idf, gt_f, k)
    assert r >= 0.95, f"filtered (masked scan over int16 store) recall {r}"

    # probe-mode filter also only surfaces allowed ids
    _, idp = idx.search(q, k, allowed=allowed, filter_mode="probe")
    idp = np.asarray(idp)
    assert np.isin(idp[idp >= 0], np.flatnonzero(allowed)).all()


def test_sharded_ivfpq_save_load_compact(rng, mesh8, tmp_path):
    n, d, k = 6000, 64, 5
    x = clustered(n, d, seed=4)
    idx = ShardedIVFPQ(IVFPQConfig(dim=d, **CFG), mesh=mesh8)
    idx.build(x)
    idx.remove([1, 3, 5])
    path = os.path.join(tmp_path, "sharded_ivfpq.npz")
    idx.save(path)
    idx2 = ShardedIVFPQ.load(path, mesh=mesh8)
    assert len(idx2) == len(idx)
    q = x[:32]
    s1, i1 = idx.search(q, k)
    s2, i2 = idx2.search(q, k)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(s1), np.asarray(s2), rtol=1e-5)

    old_ids = idx.compact()
    assert old_ids.size == n - 3
    assert len(idx) == n - 3
    _, ids = idx.search(q, 1)
    # former id 0 is still row 0; former id 2 renumbered to 1
    assert not np.isin(np.asarray(ids), [n, n + 1]).any()
