"""The reference's 10 behavioral test contracts, ported to the batched engine.

Source contracts: reference src/test_hnsw.zig (SURVEY.md §4 table). Each test
cites the reference test it mirrors. Adaptations for the batched engine follow
SURVEY.md §4: "Concurrent Access" maps to thread-safe host API + batched-build
equivalence; "Different Data Types" maps to dtype coverage (f32/bf16);
"Memory Leaks" maps to state being a pure pytree (no hidden host allocs).
"""
import threading

import numpy as np
import pytest

from zvdb_tpu import HNSW, HNSWConfig, SearchConfig


def make(dim=4, **kw):
    kw.setdefault("m", 8)
    kw.setdefault("ef_construction", 32)
    kw.setdefault("build_batch", 256)
    return HNSW(HNSWConfig(dim=dim, **kw))


def test_basic_functionality():
    # reference src/test_hnsw.zig:24-41: 3 inserts, k=2 search -> 2 results
    # sorted by distance
    idx = make(dim=3)
    idx.insert([1.0, 2.0, 3.0])
    idx.insert([4.0, 5.0, 6.0])
    idx.insert([7.0, 8.0, 9.0])
    s, i = idx.search(np.array([3.0, 4.0, 5.0], np.float32), 2)
    s, i = np.asarray(s), np.asarray(i)
    assert (i >= 0).all()
    assert s[0] <= s[1]
    # nearest two of the three points
    assert set(i.tolist()) == {0, 1}


def test_empty_index():
    # reference src/test_hnsw.zig:43-53: search on empty index -> no results
    idx = make(dim=4)
    s, i = idx.search(np.zeros(4, np.float32), 5)
    assert (np.asarray(i) == -1).all()


def test_single_point():
    # reference src/test_hnsw.zig:55-68: exact point retrievable
    idx = make(dim=4)
    p = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    idx.insert(p)
    s, i = idx.search(p, 1)
    assert int(np.asarray(i)[0]) == 0
    assert float(np.asarray(s)[0]) < 1e-6  # squared distance to itself


def test_large_dataset(rng):
    # reference src/test_hnsw.zig:70-102: 10k x 128d random, k=10 returns
    # exactly k, distance-sorted
    x = rng.standard_normal((10000, 128)).astype(np.float32)
    idx = make(dim=128, m=16, ef_construction=64, build_batch=1024)
    idx.build(x)
    q = rng.standard_normal((4, 128)).astype(np.float32)
    s, i = idx.search(q, 10)
    s, i = np.asarray(s), np.asarray(i)
    assert (i >= 0).all()
    assert i.shape == (4, 10)
    # distance-sorted (reference sorts results, src/hnsw.zig:227-233)
    assert (np.diff(s, axis=1) >= -1e-6).all()
    # and reported scores equal true squared distances to the returned ids
    true = ((q[:, None, :] - x[i]) ** 2).sum(-1)
    np.testing.assert_allclose(s, true, rtol=1e-3, atol=1e-2)


def test_edge_cases_duplicates_and_k_gt_n():
    # reference src/test_hnsw.zig:104-126: duplicate points both retrievable;
    # k > n returns only n valid results
    idx = make(dim=2)
    idx.insert([1.0, 1.0])
    idx.insert([1.0, 1.0])  # exact duplicate
    idx.insert([2.0, 2.0])
    s, i = idx.search(np.array([1.0, 1.0], np.float32), 5)
    s, i = np.asarray(s), np.asarray(i)
    valid = i[i >= 0]
    assert len(valid) == 3  # k=5 > n=3 -> 3 valid
    assert {0, 1} <= set(valid.tolist())  # both duplicates present
    assert (i[3:] == -1).all()


def test_memory_model():
    # reference src/test_hnsw.zig:128-152 (leak discipline; index owns copies).
    # Batched analog: index state is a pure pytree; the input buffer is not aliased.
    idx = make(dim=4)
    p = np.ones(4, np.float32)
    idx.insert(p)
    p[:] = 99.0  # mutate caller's buffer after insert
    s, i = idx.search(np.ones(4, np.float32), 1)
    assert float(np.asarray(s)[0]) < 1e-6  # stored copy unaffected


def test_concurrent_access(rng):
    # reference src/test_hnsw.zig:154-209: 8 threads x 1000 inserts, all
    # present afterwards; thread-safe host API
    idx = make(dim=8, build_batch=512)
    data = rng.standard_normal((8, 1000, 8)).astype(np.float32)
    errs = []

    def worker(t):
        try:
            for row in data[t]:
                idx.insert(row)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert len(idx) == 8000
    idx.flush()
    assert int(idx.state.n) == 8000
    # every external id present exactly once in the graph
    ext = np.asarray(idx.state.ext_ids)
    ext = ext[ext >= 0]
    assert len(ext) == 8000 and len(set(ext.tolist())) == 8000
    # search still works
    s, i = idx.search(data[0, 0], 5)
    assert (np.asarray(i) >= 0).all()


def test_stress_smoke(rng):
    # reference src/test_hnsw.zig:211-237 runs 100k x 128d; scaled down for CI
    # (the full-size config runs in benchmarks on real hardware)
    x = rng.standard_normal((20000, 64)).astype(np.float32)
    idx = make(dim=64, m=16, ef_construction=64, build_batch=2048)
    idx.build(x)
    q = rng.standard_normal((100, 64)).astype(np.float32)
    s, i = idx.search(q, 10)
    assert (np.asarray(i) >= 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_different_data_types(rng, dtype):
    # reference src/test_hnsw.zig:239-273 instantiates HNSW(i32)/HNSW(f64);
    # the batched analog is storage-dtype coverage
    x = rng.standard_normal((500, 16)).astype(np.float32)
    idx = make(dim=16, dtype=dtype)
    idx.build(x)
    s, i = idx.search(x[:32], 1, ef_search=64)
    acc = (np.asarray(i)[:, 0] == np.arange(32)).mean()
    assert acc >= (1.0 if dtype == "float32" else 0.9)


def test_consistency_deterministic_search(rng):
    # reference src/test_hnsw.zig:275-317: same query repeated 10x on a frozen
    # index -> identical results
    x = rng.standard_normal((2000, 16)).astype(np.float32)
    idx = make(dim=16)
    idx.build(x)
    q = rng.standard_normal((1, 16)).astype(np.float32)
    s0, i0 = idx.search(q, 10)
    for _ in range(9):
        s, i = idx.search(q, 10)
        np.testing.assert_array_equal(np.asarray(i), np.asarray(i0))
        np.testing.assert_array_equal(np.asarray(s), np.asarray(s0))


def test_deterministic_build_under_fixed_seed(rng):
    # new contract (SURVEY.md §4): identical PRNG seed -> identical graph
    x = rng.standard_normal((1000, 16)).astype(np.float32)
    a = HNSW(HNSWConfig(dim=16, m=8, build_batch=256), seed=7)
    b = HNSW(HNSWConfig(dim=16, m=8, build_batch=256), seed=7)
    a.build(x)
    b.build(x)
    np.testing.assert_array_equal(np.asarray(a.state.nbr0), np.asarray(b.state.nbr0))
    np.testing.assert_array_equal(np.asarray(a.state.levels), np.asarray(b.state.levels))


def test_incremental_matches_semantics(rng):
    # batched insert ≡ sequential insert semantics: all points searchable,
    # ids assigned in arrival order (reference: dense sequential ids,
    # src/hnsw.zig:77)
    x = rng.standard_normal((600, 8)).astype(np.float32)
    idx = make(dim=8, build_batch=256)
    idx.insert(x[:100])        # batch insert
    for r in x[100:110]:       # single inserts
        idx.insert(r)
    idx.insert(x[110:600])
    assert len(idx) == 600
    s, i = idx.search(x[105], 1, ef_search=64)
    assert int(np.asarray(i)[0]) == 105
