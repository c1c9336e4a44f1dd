"""CAGRA-style single-layer graph engine + cluster-kNN construction.

The graph build is all-matmul (no beam loops): spilled k-means blocks ->
per-block brute force -> diversity prune -> reverse edges -> long-range links
(index/knn_graph.py). The same machinery powers HNSW's oneshot bulk build.
Contracts mirror the reference surface (src/hnsw.zig: insert/search; empty
index src/test_hnsw.zig:43-53; k>n clamp :104-126; determinism :275-317).
"""
import numpy as np
import pytest

from zvdb_tpu import CagraConfig, CagraIndex, HNSW, HNSWConfig, exact_ground_truth


def recall_at_k(ids, gt_ids, k):
    return np.mean(
        [len(set(ids[r, :k]) & set(gt_ids[r, :k])) / k for r in range(ids.shape[0])]
    )


def clustered(n, d, seed, nc=50):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nc, d)).astype(np.float32)
    a = rng.integers(0, nc, n)
    return (centers[a] + 0.15 * rng.standard_normal((n, d))).astype(np.float32)


# ---------------------------------------------------------------------------
# knn_graph construction


def test_knn_graph_edge_recall_and_connectivity(rng):
    import jax

    from zvdb_tpu.bench.harness import ground_truth_host
    from zvdb_tpu.index.knn_graph import build_knn_graph

    n, d = 12000, 32
    x = clustered(n, d, seed=1)
    nbrs, dists, cent, cn, c_rows = build_knn_graph(
        x, degree=32, key=jax.random.PRNGKey(0)
    )
    nb = np.asarray(nbrs)[:n]
    _, gt = ground_truth_host(x, x, 11)
    gt = gt[:, 1:]
    hit = np.mean([len(set(nb[i]) & set(gt[i])) / 10 for i in range(0, n, 20)])
    assert hit >= 0.90, f"edge 10-NN recall {hit:.3f}"
    deg = (nb >= 0).sum(1)
    assert (deg == 0).sum() == 0, "no isolated nodes"
    assert c_rows.ndim == 2 and int(np.asarray(c_rows).max()) < n
    # stored edge distances are true squared L2 of the endpoints
    i, j = 5, int(nb[5, 0])
    want = float(((x[5] - x[j]) ** 2).sum())
    np.testing.assert_allclose(float(np.asarray(dists)[5, 0]), want, rtol=1e-3)


# ---------------------------------------------------------------------------
# engine contracts


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_cagra_recall(rng, metric):
    n, d, k = 15000, 32, 10
    x = clustered(n, d, seed=2)
    q = (x[rng.integers(0, n, 300)]
         + 0.05 * rng.standard_normal((300, d))).astype(np.float32)
    _, gt = exact_ground_truth(x, q, k, metric=metric)
    idx = CagraIndex(CagraConfig(dim=d, degree=32, metric=metric))
    idx.build(x)
    _, ids = idx.search(q, k, ef_search=48)
    r = recall_at_k(np.asarray(ids), gt, k)
    assert r >= 0.93, f"{metric} recall {r:.3f}"


def test_cagra_insert_and_self_hit(rng):
    n, d = 8000, 16
    x = clustered(n, d, seed=3)
    idx = CagraIndex(CagraConfig(dim=d, degree=24))
    idx.build(x)
    _, si = idx.search(x[:200], 1)
    assert (np.asarray(si)[:, 0] == np.arange(200)).mean() >= 0.95
    extra = clustered(500, d, seed=4)
    idx.insert(extra)
    assert len(idx) == n + 500
    _, ei = idx.search(extra[:100], 1, ef_search=48)
    assert (np.asarray(ei)[:, 0] == n + np.arange(100)).mean() >= 0.9
    # old points still findable after extend
    _, si2 = idx.search(x[:100], 1)
    assert (np.asarray(si2)[:, 0] == np.arange(100)).mean() >= 0.95


def test_cagra_empty_and_k_gt_n(rng):
    idx = CagraIndex(CagraConfig(dim=8, degree=8))
    s, i = idx.search(np.zeros(8, np.float32), 3)
    assert (np.asarray(i) == -1).all()          # empty index -> no results
    x = rng.standard_normal((5, 8)).astype(np.float32)
    idx.insert(x)
    s, i = idx.search(x[0], 10)
    i = np.asarray(i)
    assert (i >= 0).sum() == 5                  # k > n returns n results
    assert i[0] == 0
    with pytest.raises(ValueError):
        idx.search(np.zeros(9, np.float32), 2)  # dim mismatch raises


def test_cagra_deterministic_search(rng):
    x = clustered(3000, 16, seed=5)
    idx = CagraIndex(CagraConfig(dim=16, degree=16, seed=7))
    idx.build(x)
    q = x[:32]
    runs = [np.asarray(idx.search(q, 5)[1]) for _ in range(3)]
    for r in runs[1:]:
        np.testing.assert_array_equal(runs[0], r)


def test_cagra_save_load_get(tmp_path, rng):
    x = clustered(4000, 16, seed=6)
    idx = CagraIndex(CagraConfig(dim=16, degree=16))
    idx.build(x)
    q = x[:16]
    s0, i0 = idx.search(q, 5)
    path = str(tmp_path / "cagra.npz")
    idx.save(path)
    loaded = CagraIndex.load(path)
    s1, i1 = loaded.search(q, 5)
    np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
    np.testing.assert_allclose(np.asarray(s0), np.asarray(s1), rtol=1e-6)
    np.testing.assert_allclose(loaded.get([0, 100]), x[[0, 100]], rtol=1e-6)
    loaded.insert(x[:10] + 0.5)
    assert len(loaded) == 4010


def test_cagra_int8(rng):
    n, d, k = 8000, 32, 10
    x = clustered(n, d, seed=8)
    q = x[rng.integers(0, n, 200)].astype(np.float32)
    idx = CagraIndex(CagraConfig(dim=d, degree=24, dtype="int8"))
    idx.build(x)
    assert str(idx.state.vectors.dtype) == "int8"
    _, ids = idx.search(q, k, ef_search=48)
    # judged against exact kNN over the dequantized stored data
    x_deq = idx.get(np.arange(n))
    _, gt_deq = exact_ground_truth(x_deq, q, k)
    r = recall_at_k(np.asarray(ids), gt_deq, k)
    assert r >= 0.90, f"int8 cagra recall vs stored-data oracle {r:.3f}"


# ---------------------------------------------------------------------------
# oneshot HNSW bulk build (same construction machinery)


def test_hnsw_oneshot_build_recall_and_extend(rng):
    n, d, k = 15000, 32, 10
    x = clustered(n, d, seed=9)
    q = (x[rng.integers(0, n, 300)]
         + 0.05 * rng.standard_normal((300, d))).astype(np.float32)
    _, gt = exact_ground_truth(x, q, k)
    idx = HNSW(HNSWConfig(dim=d, m=16, ef_construction=100))  # auto -> oneshot
    idx.build(x)
    _, ids = idx.search(q, k, ef_search=48)
    r = recall_at_k(np.asarray(ids), gt, k)
    assert r >= 0.95, f"oneshot recall {r:.3f}"
    # incremental extend on top of a oneshot-built graph
    extra = clustered(200, d, seed=10)
    idx.insert(extra)
    _, ei = idx.search(extra[:64], 1, ef_search=48)
    assert (np.asarray(ei)[:, 0] == n + np.arange(64)).mean() >= 0.9


def test_hnsw_oneshot_deterministic(rng):
    x = clustered(3000, 16, seed=11)
    a = HNSW(HNSWConfig(dim=16, m=8, ef_construction=48), seed=3)
    b = HNSW(HNSWConfig(dim=16, m=8, ef_construction=48), seed=3)
    a.build(x)
    b.build(x)
    np.testing.assert_array_equal(np.asarray(a.state.nbr0), np.asarray(b.state.nbr0))
    np.testing.assert_array_equal(np.asarray(a.state.levels), np.asarray(b.state.levels))


def test_segmented_upload_overlap_build(rng, monkeypatch):
    """The upload-overlap build (segmented device_put + pass-0 clustering on
    the landed prefix) must match the single-upload path's quality.
    Exercised by shrinking the size gate (real gate: 64k rows)."""
    import zvdb_tpu.index.cagra as C

    monkeypatch.setattr(C, "_OVERLAP_MIN_N", 1000)
    nc, n, d = 50, 6000, 16
    centers = rng.standard_normal((nc, d)).astype(np.float32)
    x = (centers[rng.integers(0, nc, n)]
         + 0.12 * rng.standard_normal((n, d))).astype(np.float32)
    idx = CagraIndex(CagraConfig(dim=d, degree=16, upload_segments=8))
    idx.build(x[:5997])   # odd n exercises the tail segment
    ids = np.asarray(idx.search(x[:512], 1, ef_search=24)[1])
    assert (ids[:, 0] == np.arange(512)).mean() >= 0.9


def test_search_knob_overrides_match_config():
    """Per-call search_degree/max_iters overrides must produce exactly the
    results of an identically-configured index (search-time-only knobs; the
    graph state is untouched)."""
    import dataclasses

    x = clustered(4000, 16, seed=21)
    q = x[:128]
    base = CagraConfig(dim=16, degree=16, search_degree=24, max_iters=8, seed=5)
    idx = CagraIndex(base)
    idx.build(x)
    s_o, i_o = idx.search(q, 5, ef_search=16, search_degree=8, max_iters=3)
    # same state under the overridden config
    other = CagraIndex(
        dataclasses.replace(base, search_degree=8, max_iters=3))
    other.state = idx.state
    s_c, i_c = other.search(q, 5, ef_search=16)
    np.testing.assert_array_equal(np.asarray(i_o), np.asarray(i_c))
    np.testing.assert_allclose(np.asarray(s_o), np.asarray(s_c), rtol=1e-6)
    # and overrides don't stick: a plain search matches the original config
    s_a, i_a = idx.search(q, 5, ef_search=16)
    other2 = CagraIndex(base)
    other2.state = idx.state
    s_b, i_b = other2.search(q, 5, ef_search=16)
    np.testing.assert_array_equal(np.asarray(i_a), np.asarray(i_b))


def test_hnsw_search_knob_overrides_match_config():
    """HNSW per-call search_degree/max_iters match an index whose search_cfg
    carries the same values (API symmetry with CagraIndex.search)."""
    import dataclasses

    x = clustered(4000, 16, seed=22)
    q = x[:128]
    idx = HNSW(HNSWConfig(dim=16, m=16, ef_construction=64), seed=7)
    idx.build(x)
    s_o, i_o = idx.search(q, 5, ef_search=16, search_degree=8, max_iters=3)
    other = HNSW(HNSWConfig(dim=16, m=16, ef_construction=64), seed=7)
    other.state = idx.state
    other.levels_cap = idx.levels_cap
    other.search_cfg = dataclasses.replace(
        other.search_cfg, search_degree=8, max_iters=3)
    s_c, i_c = other.search(q, 5, ef_search=16)
    np.testing.assert_array_equal(np.asarray(i_o), np.asarray(i_c))
    np.testing.assert_allclose(np.asarray(s_o), np.asarray(s_c), rtol=1e-6)
