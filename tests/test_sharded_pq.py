"""ShardedPQFlat: mesh-sharded product-quantized search (parallel/sharded_pq.py).

Contracts mirror the single-chip PQFlatIndex tests (test_pq.py) plus the
sharded-family contracts (global ids, least-loaded insert routing, mesh
save/load, filtered search, delete/compact) — SURVEY.md §2.3 ledger.
"""
import numpy as np
import pytest

from zvdb_tpu import PQConfig, exact_ground_truth
from zvdb_tpu.parallel.mesh import make_mesh
from zvdb_tpu.parallel.sharded_pq import ShardedPQFlat

# compile-heavy multi-device tier — deselect with -m 'not slow' (fast gate)
pytestmark = pytest.mark.slow


def recall_at_k(ids, gt_ids, k):
    return np.mean(
        [len(set(ids[r, :k]) & set(gt_ids[r, :k])) / k
         for r in range(ids.shape[0])]
    )


def clustered(n, d, seed, nc=50):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nc, d)).astype(np.float32)
    a = rng.integers(0, nc, n)
    return (centers[a] + 0.15 * rng.standard_normal((n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    n, d = 8000, 32
    x = clustered(n, d, seed=11)
    rng = np.random.default_rng(12)
    q = (x[rng.integers(0, n, 200)]
         + 0.05 * rng.standard_normal((200, d))).astype(np.float32)
    _, gt = exact_ground_truth(x, q, 10)
    return x, q, gt


def _mk(d=32, refine="int8", **kw):
    # n_codes pinned to 256: these fixtures deliberately use coarse dsub=4
    # subspaces to exercise refine-repair at the classic 8-bit resolution
    # (4-bit coverage: test_pq.py's pq4 block + the winner-default tests)
    kw.setdefault("n_codes", 256)
    cfg = PQConfig(dim=d, n_sub=8, refine=refine, rerank=8,
                   train_sample=2048, tile_n=1024, **kw)
    return ShardedPQFlat(cfg, mesh=make_mesh(n_shards=4))


def test_recall_refined(corpus):
    x, q, gt = corpus
    idx = _mk()
    idx.build(x)
    s, ids = idx.search(q, 10)
    r = recall_at_k(np.asarray(ids), gt, 10)
    assert r >= 0.9, f"sharded PQ int8-refine recall {r:.3f}"
    # global external ids, squared-L2 user scores ascending
    ids = np.asarray(ids)
    s = np.asarray(s)
    assert ids.max() < x.shape[0] and ids.min() >= 0
    assert (np.diff(s, axis=1) >= -1e-5).all()


def test_matches_single_chip_family_semantics(corpus):
    """Self-query: nearest neighbor of a stored row is itself."""
    x, _, _ = corpus
    idx = _mk()
    idx.build(x)
    _, ids = idx.search(x[:128], 1)
    hit = (np.asarray(ids)[:, 0] == np.arange(128)).mean()
    assert hit >= 0.95  # PQ+refine: near-exact on stored rows


def test_add_routes_and_searches(corpus):
    x, _, _ = corpus
    idx = _mk()
    idx.build(x[:6000])
    idx.add(x[6000:])          # buffered; flushed by search
    assert len(idx) == x.shape[0]
    _, ids = idx.search(x[6000:6128], 1)
    hit = (np.asarray(ids)[:, 0] == np.arange(6000, 6128)).mean()
    assert hit >= 0.95
    # appended rows landed on the least-loaded shards: balance within 1 chunk
    spread = idx._per_shard_n.max() - idx._per_shard_n.min()
    assert spread <= 2048


def test_add_trains_on_first_flush():
    x = clustered(3000, 16, seed=3)
    idx = ShardedPQFlat(
        PQConfig(dim=16, n_sub=4, n_codes=256, refine="int8", rerank=8,
                 train_sample=1024, tile_n=512),
        mesh=make_mesh(n_shards=4))
    idx.add(x)
    _, ids = idx.search(x[:64], 1)
    assert (np.asarray(ids)[:, 0] == np.arange(64)).mean() >= 0.95


def test_growth_past_capacity():
    x = clustered(4000, 16, seed=5)
    idx = ShardedPQFlat(
        PQConfig(dim=16, n_sub=4, n_codes=256, refine="int8", rerank=8,
                 train_sample=1024, tile_n=512),
        mesh=make_mesh(n_shards=4))
    idx.build(x[:1000])
    for lo in range(1000, 4000, 500):
        idx.add(x[lo:lo + 500])
        idx.flush()
    _, ids = idx.search(x[3500:3564], 1)
    assert (np.asarray(ids)[:, 0] == np.arange(3500, 3564)).mean() >= 0.95


def test_remove_and_compact(corpus):
    x, q, _ = corpus
    idx = _mk()
    idx.build(x)
    victims = np.asarray(idx.search(q[:32], 1)[1])[:, 0]
    n_del = idx.remove(victims)
    assert n_del == np.unique(victims).size
    _, ids = idx.search(q[:32], 5)
    assert not np.isin(np.asarray(ids), victims).any()
    assert len(idx) == x.shape[0] - n_del
    old_ids = idx.compact()
    assert old_ids.size == x.shape[0] - n_del
    assert not np.isin(old_ids, victims).any()
    # survivors renumbered to [0, L) in former order; search still works
    _, ids2 = idx.search(q[:32], 5)
    assert np.asarray(ids2).max() < old_ids.size
    # idempotent double-delete
    remapped = {int(o): i for i, o in enumerate(old_ids)}
    assert idx.remove([]) == 0


def test_filtered_search(corpus):
    x, q, gt = corpus
    idx = _mk()
    idx.build(x)
    allowed = np.arange(0, x.shape[0], 2)   # even ids only
    _, ids = idx.search(q, 10, allowed=allowed)
    ids = np.asarray(ids)
    live = ids[ids >= 0]
    assert (live % 2 == 0).all()
    # filtered result == oracle over the allowed subset (refine is exact)
    _, gt_f = exact_ground_truth(x[allowed], q[:32], 5)
    _, idf = idx.search(q[:32], 5, allowed=allowed)
    r = recall_at_k(np.asarray(idf) // 2, gt_f, 5)
    assert r >= 0.9


def test_save_load_roundtrip(tmp_path, corpus):
    x, q, _ = corpus
    idx = _mk()
    idx.build(x)
    idx.remove([7, 8])
    p = str(tmp_path / "spq.npz")
    idx.save(p)
    back = ShardedPQFlat.load(p, mesh=make_mesh(n_shards=4))
    s0, i0 = idx.search(q[:64], 10)
    s1, i1 = back.search(q[:64], 10)
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
    np.testing.assert_allclose(np.asarray(s0), np.asarray(s1), rtol=1e-5)
    assert back._dead == idx._dead


def test_empty_and_k_gt_n():
    cfg = PQConfig(dim=16, n_sub=4, refine="int8", train_sample=512,
                   tile_n=512)
    idx = ShardedPQFlat(cfg, mesh=make_mesh(n_shards=4))
    s, ids = idx.search(np.zeros((3, 16), np.float32), 5)
    assert (np.asarray(ids) == -1).all()
    x = clustered(7, 16, seed=9)
    idx.build(x)
    s, ids = idx.search(x[:2], 10)   # k > n
    ids = np.asarray(ids)
    assert (ids[:, :7] >= 0).all() and (np.sort(ids[0])[-7:] >= 0).all()
    assert (ids == -1).sum(axis=1).min() >= 3


def test_get_and_dim_mismatch(corpus):
    x, _, _ = corpus
    idx = _mk()
    idx.build(x)
    got = idx.get([0, 5, 4096])
    assert got.shape == (3, 32)
    # int8 refine store: near-exact reconstruction
    err = np.abs(got - x[[0, 5, 4096]]).max() / np.abs(x).max()
    assert err < 0.02
    with pytest.raises(ValueError):
        idx.search(np.zeros((1, 8), np.float32), 3)
    with pytest.raises(ValueError):
        idx.add(np.zeros((1, 8), np.float32))
    with pytest.raises(IndexError):
        idx.get([99999])


def test_refine_none_codes_only(corpus):
    """Pure-codes footprint: recall is bounded by code resolution (the
    single-chip engine sets the bar on the same data — test_pq.py asserts
    the monotone-in-n_sub shape, not an absolute floor); sharded must
    match the single-chip number, not degrade it."""
    from zvdb_tpu import PQFlatIndex

    x, q, gt = corpus
    idx = _mk(refine="none")
    idx.build(x)
    _, ids = idx.search(q, 10)
    r = recall_at_k(np.asarray(ids), gt, 10)
    ref = PQFlatIndex(PQConfig(dim=32, n_sub=8, n_codes=256, refine="none",
                               train_sample=2048, tile_n=1024))
    ref.build(x)
    _, rid = ref.search(q, 10)
    r_single = recall_at_k(np.asarray(rid), gt, 10)
    assert r >= r_single - 0.05, f"sharded {r:.3f} vs single {r_single:.3f}"
    assert r >= 0.2


def test_cosine_metric():
    x = clustered(4000, 32, seed=21)
    rng = np.random.default_rng(22)
    q = (x[rng.integers(0, 4000, 100)]
         + 0.05 * rng.standard_normal((100, 32))).astype(np.float32)
    xs = x / np.linalg.norm(x, axis=1, keepdims=True)
    qs = q / np.linalg.norm(q, axis=1, keepdims=True)
    gt = np.argsort(-(qs @ xs.T), axis=1)[:, :10]
    # f32 refine: exact rerank -> near-perfect recall
    idx = ShardedPQFlat(
        PQConfig(dim=32, n_sub=8, metric="cosine", refine="float32",
                 rerank=8, train_sample=2048, tile_n=1024),
        mesh=make_mesh(n_shards=4))
    idx.build(x)
    s, ids = idx.search(q, 10)
    r = recall_at_k(np.asarray(ids), gt, 10)
    assert r >= 0.95, f"cosine sharded PQ (f32 refine) recall {r:.3f}"
    # similarity scores: higher is better, descending
    s = np.asarray(s)
    assert (np.diff(s, axis=1) <= 1e-5).all()
    # int8 refine: near-tie reordering bounds recall on normalized tight
    # clusters (measured ~0.87 single-chip on this data) — sharded must be
    # at parity with the single-chip engine, not degrade it
    from zvdb_tpu import PQFlatIndex

    cfg8 = PQConfig(dim=32, n_sub=8, metric="cosine", refine="int8",
                    rerank=8, train_sample=2048, tile_n=1024)
    sh = ShardedPQFlat(cfg8, mesh=make_mesh(n_shards=4))
    sh.build(x)
    single = PQFlatIndex(cfg8)
    single.build(x)
    r_sh = recall_at_k(np.asarray(sh.search(q, 10)[1]), gt, 10)
    r_si = recall_at_k(np.asarray(single.search(q, 10)[1]), gt, 10)
    assert r_sh >= r_si - 0.03, f"sharded {r_sh:.3f} vs single {r_si:.3f}"


def test_opq_sharded_matches_single_chip():
    """OPQ on the mesh: codes in rotated space, refine in original space,
    recall at parity with the single-chip OPQ engine (test_pq.py OPQ
    contracts); get() returns original-space vectors."""
    rng = np.random.default_rng(3)
    n, d = 6000, 32
    lam = np.exp(-np.arange(d) / 6.0)
    z = rng.standard_normal((n, d)).astype(np.float32) * lam
    mix = np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32)
    x = (z @ mix).astype(np.float32)
    q = (x[rng.integers(0, n, 100)]
         + 0.01 * rng.standard_normal((100, d))).astype(np.float32)
    _, gt = exact_ground_truth(x, q, 10)
    cfg = PQConfig(dim=d, n_sub=8, refine="none", train_sample=2048,
                   tile_n=1024, opq=True)
    sh = ShardedPQFlat(cfg, mesh=make_mesh(n_shards=4))
    sh.build(x)
    from zvdb_tpu import PQFlatIndex

    single = PQFlatIndex(cfg)
    single.build(x)
    r_sh = recall_at_k(np.asarray(sh.search(q, 10)[1]), np.asarray(gt), 10)
    r_si = recall_at_k(np.asarray(single.search(q, 10)[1]), np.asarray(gt), 10)
    assert r_sh >= r_si - 0.03, f"sharded {r_sh:.3f} vs single {r_si:.3f}"
    # pure-codes get(): decoded in rotated space, returned in user space
    g = sh.get(np.arange(200))
    base = np.mean(x[:200] ** 2)
    assert float(np.mean((g - x[:200]) ** 2)) < 0.2 * base
    # save/load keeps the rotation
    import tempfile, os
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "opq_sh.npz")
        sh.save(p)
        sh2 = ShardedPQFlat.load(p, mesh=make_mesh(n_shards=4))
        np.testing.assert_array_equal(np.asarray(sh.search(q, 10)[1]),
                                      np.asarray(sh2.search(q, 10)[1]))


def test_packed_codes_rerank_override(corpus):
    """4-bit nibble codes per shard on the decode-tile scan: recall floor,
    global-id/score conventions intact, and the per-call rerank override
    (ShardedPQFlat.search(..., rerank=)) deepens the per-shard pool."""
    x, q, gt = corpus
    idx = _mk(n_codes=16)
    idx.build(x)
    s, ids = idx.search(q, 10)
    r = recall_at_k(np.asarray(ids), gt, 10)
    assert r >= 0.9, f"sharded 4-bit recall {r:.3f}"
    ids = np.asarray(ids)
    s = np.asarray(s)
    assert ids.max() < x.shape[0] and ids.min() >= 0
    assert (np.diff(s, axis=1) >= -1e-5).all()
    # deeper per-call rerank: may only help (wider exact-rescored pool)
    r2 = recall_at_k(np.asarray(idx.search(q, 10, rerank=16)[1]), gt, 10)
    assert r2 >= r - 0.02, f"rerank=16 {r2:.3f} < default {r:.3f}"
