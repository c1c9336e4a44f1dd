"""Fused flat scan + bin fold (ops/flat_scan.py, Pallas on the Triton route).

The kernel runs in the Pallas interpreter on the CPU; these tests pin its
arithmetic against the plain jnp reference, plus the wrapper's padding,
shapes and the engine's choice of path. The compiled kernel is checked on
the card by chip_smoke.py (phase "kernels").
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zvdb_tpu.ops import distance as D
from zvdb_tpu.ops.flat_scan import flat_scan_bins, flat_scan_topk

I = dict(interpret=True)
# exactness tests pin the f32 path; "default" scores in bf16
X = dict(interpret=True, precision="highest")


def _mk(n, d, b, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    return x, q


def test_exact_when_bins_cover_corpus():
    # N <= L: c % L is injective, so every bin holds exactly one row and
    # the result must equal the exact top-k.
    x, q = _mk(50, 17, 7)
    norms = D.sq_norms(jnp.asarray(x))
    s, ids = flat_scan_topk(jnp.asarray(q), jnp.asarray(x), norms, k=5,
                            l_bins=64, seg_rows=64, bq=16, **X)
    ref = D.pairwise_scores(jnp.asarray(q), jnp.asarray(x), norms, "l2",
                            precision=jax.lax.Precision.HIGHEST)
    rs, ri = jax.lax.top_k(-ref, 5)
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(ri))
    np.testing.assert_allclose(np.asarray(s), -np.asarray(rs), rtol=1e-5)


def test_bins_are_true_bin_minima():
    # each returned bin value must be the exact min over its (segment,
    # residue) class: row r of segment g lands in column g*L + r % L
    n, l_bins, seg = 300, 32, 128
    x, q = _mk(n, 24, 5, seed=1)
    norms = D.sq_norms(jnp.asarray(x))
    bs, bi = flat_scan_bins(jnp.asarray(q), jnp.asarray(x), norms,
                            l_bins=l_bins, seg_rows=seg, bq=16, per_bin=1,
                            **X)
    n_seg = -(-n // seg)
    assert bs.shape == (5, n_seg * l_bins) and bi.shape == bs.shape
    ref = np.asarray(D.pairwise_scores(
        jnp.asarray(q), jnp.asarray(x), norms, "l2",
        precision=jax.lax.Precision.HIGHEST))
    rows = np.arange(n)
    col = (rows // seg) * l_bins + rows % l_bins
    for c in range(n_seg * l_bins):
        members = rows[col == c]
        if members.size == 0:
            assert np.all(np.asarray(bi)[:, c] == -1)
            continue
        want = ref[:, members].min(axis=1)
        np.testing.assert_allclose(np.asarray(bs)[:, c], want, rtol=1e-5,
                                   atol=1e-5)
        got_ids = np.asarray(bi)[:, c]
        assert np.all(np.isin(got_ids, members))
        np.testing.assert_allclose(ref[np.arange(5), got_ids], want,
                                   rtol=1e-5, atol=1e-5)


def test_per_bin2_keeps_runner_up():
    # per_bin=2: per segment, columns [0, L) are the bin minima and
    # [L, 2L) each bin's second-best row (numpy sort of its members)
    n, l_bins, seg = 600, 32, 256
    x, q = _mk(n, 24, 4, seed=7)
    norms = D.sq_norms(jnp.asarray(x))
    bs, bi = flat_scan_bins(jnp.asarray(q), jnp.asarray(x), norms,
                            l_bins=l_bins, seg_rows=seg, bq=16, per_bin=2,
                            **X)
    bs, bi = np.asarray(bs), np.asarray(bi)
    ref = np.asarray(D.pairwise_scores(
        jnp.asarray(q), jnp.asarray(x), norms, "l2",
        precision=jax.lax.Precision.HIGHEST))
    rows = np.arange(n)
    for g in range(-(-n // seg)):
        for lane in range(0, l_bins, 5):
            members = rows[(rows // seg == g) & (rows % l_bins == lane)]
            order = np.sort(ref[:, members], axis=1)
            c = g * 2 * l_bins + lane
            np.testing.assert_allclose(bs[:, c], order[:, 0], rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(bs[:, c + l_bins], order[:, 1],
                                       rtol=1e-5, atol=1e-5)
            assert np.all(bi[:, c] != bi[:, c + l_bins])


def test_recall_beats_collision_bound():
    # one segment: selection recall is the single-pool collision bound
    x, q = _mk(4096, 32, 64, seed=2)
    k, L = 10, 128
    norms = D.sq_norms(jnp.asarray(x))
    _, ids = flat_scan_topk(jnp.asarray(q), jnp.asarray(x), norms, k=k,
                            l_bins=L, seg_rows=4096, bq=16, per_bin=1, **I)
    ref = D.pairwise_scores(jnp.asarray(q), jnp.asarray(x), norms, "l2",
                            precision=jax.lax.Precision.HIGHEST)
    _, gt = jax.lax.top_k(-ref, k)
    hit = np.mean([
        len(set(np.asarray(ids)[i]) & set(np.asarray(gt)[i])) / k
        for i in range(ids.shape[0])
    ])
    bound = L / k * (1 - (1 - 1 / L) ** k)   # 0.965 at k=10, L=128
    assert hit >= bound - 0.03, hit


def test_dot_metric_and_invalid_rows():
    x, q = _mk(100, 16, 4, seed=3)
    norms = jnp.zeros((100,)).at[60:].set(jnp.inf)   # rows 60+ invalid
    s, ids = flat_scan_topk(jnp.asarray(q), jnp.asarray(x), norms, k=4,
                            l_bins=128, seg_rows=128, bq=16, metric="dot",
                            **X)
    assert np.asarray(ids).max() < 60
    ref = np.asarray(D.pairwise_scores(
        jnp.asarray(q), jnp.asarray(x[:60]), jnp.zeros((60,)), "dot",
        precision=jax.lax.Precision.HIGHEST))
    rs, ri = jax.lax.top_k(-jnp.asarray(ref), 4)
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(ri))


def test_k_larger_than_bins_pads_invalid():
    x, q = _mk(20, 8, 3, seed=4)
    norms = D.sq_norms(jnp.asarray(x))
    s, ids = flat_scan_topk(jnp.asarray(q), jnp.asarray(x), norms, k=40,
                            l_bins=32, seg_rows=32, bq=16, per_bin=1, **I)
    assert s.shape == (3, 40) and ids.shape == (3, 40)
    assert np.all(np.asarray(ids)[:, 32:] == -1)
    assert np.all(np.isinf(np.asarray(s)[:, 32:]))
    # the first 20 slots cover the whole corpus exactly
    assert np.all(np.sort(np.asarray(ids)[:, :20], axis=1) == np.arange(20))


def test_flat_engine_pallas_path_matches():
    # FlatIndex(scan="pallas") agrees with the exact engine (interpreter)
    from zvdb_tpu import FlatConfig, FlatIndex

    x, q = _mk(500, 13, 16, seed=5)
    exact = FlatIndex(FlatConfig(dim=13), capacity=512)
    exact.add(x)
    es, ei = exact.search(q, 10)
    pal = FlatIndex(FlatConfig(dim=13, scan="pallas", l_bins=512,
                               pallas_chunk=512), capacity=512)
    pal.add(x)
    ps, pi = pal.search(q, 10, approx=True)
    np.testing.assert_array_equal(np.asarray(pi), np.asarray(ei))
    np.testing.assert_allclose(np.asarray(ps), np.asarray(es), rtol=1e-4,
                               atol=1e-4)


def test_bitonic_smallest_k_matches_topk():
    from zvdb_tpu.ops.topk import bitonic_smallest_k, smallest_k

    rng = np.random.default_rng(0)
    s = rng.standard_normal((257, 48)).astype(np.float32)
    ids = rng.permutation(257 * 48).reshape(257, 48).astype(np.int32)
    # sprinkle invalid slots
    s[rng.random((257, 48)) < 0.1] = np.inf
    ids = np.where(np.isinf(s), -1, ids)
    bs, bi = bitonic_smallest_k(jnp.asarray(s), jnp.asarray(ids), 13)
    rs, ri = smallest_k(jnp.asarray(s), jnp.asarray(ids), 13)
    # same multisets of (score, id): order ties may differ (id vs position)
    np.testing.assert_allclose(np.sort(np.asarray(bs)), np.sort(np.asarray(rs)))
    assert np.all(np.asarray(bs)[:, :-1] <= np.asarray(bs)[:, 1:])  # sorted
    valid = np.asarray(bi) >= 0
    np.testing.assert_array_equal(np.asarray(bi)[~valid], -1 * np.ones(0))
    # every returned (s, id) pair exists in the input row
    for r in range(0, 257, 64):
        for c in range(13):
            if np.asarray(bi)[r, c] >= 0:
                assert np.asarray(bi)[r, c] in ids[r]


def test_bitonic_k_exceeds_width():
    from zvdb_tpu.ops.topk import bitonic_smallest_k

    s = jnp.asarray([[3.0, 1.0, 2.0]])
    ids = jnp.asarray([[30, 10, 20]], dtype=jnp.int32)
    bs, bi = bitonic_smallest_k(s, ids, 5)
    np.testing.assert_array_equal(np.asarray(bi), [[10, 20, 30, -1, -1]])
    assert np.isinf(np.asarray(bs)[0, 3:]).all()


def test_sort_smallest_k_dedupes_exactly():
    from zvdb_tpu.ops.topk import sort_smallest_k

    s = jnp.asarray([[5.0, 1.0, 1.0 + 1e-7, 3.0, np.inf, 2.0]])
    ids = jnp.asarray([[7, 4, 4, 9, -1, 11]], dtype=jnp.int32)
    bs, bi = sort_smallest_k(s, ids, 4, dedupe=True)
    # id 4 appears twice with ulp-different scores: kept once (smaller score)
    np.testing.assert_array_equal(np.asarray(bi), [[4, 11, 9, 7]])
    np.testing.assert_allclose(np.asarray(bs)[0], [1.0, 2.0, 3.0, 5.0])


def test_sort_smallest_k_matches_topk():
    from zvdb_tpu.ops.topk import smallest_k, sort_smallest_k

    rng = np.random.default_rng(3)
    s = rng.standard_normal((500, 48)).astype(np.float32)
    ids = rng.permutation(500 * 48).reshape(500, 48).astype(np.int32)
    s[rng.random((500, 48)) < 0.1] = np.inf
    ids = np.where(np.isinf(s), -1, ids)
    bs, bi = sort_smallest_k(jnp.asarray(s), jnp.asarray(ids), 16)
    rs, ri = smallest_k(jnp.asarray(s), jnp.asarray(ids), 16)
    np.testing.assert_array_equal(np.asarray(bi), np.asarray(ri))
    np.testing.assert_allclose(np.asarray(bs), np.asarray(rs))


def test_flat_engine_pallas_rerank_path():
    """bf16 in-kernel scan + exact f32 rerank: the FlatIndex fused path
    with rerank set scans at scan_precision, and the rescored candidates
    must reach the exact ranking."""
    from zvdb_tpu import FlatConfig, FlatIndex
    from zvdb_tpu.bench.harness import ground_truth_host, recall_at_k

    rng = np.random.default_rng(5)
    nc, n, d, b, k = 40, 3000, 32, 64, 10
    centers = rng.standard_normal((nc, d)).astype(np.float32)
    x = (centers[rng.integers(0, nc, n)]
         + 0.1 * rng.standard_normal((n, d))).astype(np.float32)
    q = (x[rng.integers(0, n, b)]
         + 0.05 * rng.standard_normal((b, d))).astype(np.float32)
    _, gt = ground_truth_host(x, q, k, "l2")

    idx = FlatIndex(FlatConfig(dim=d, scan="pallas", rerank=4,
                               l_bins=128, pallas_chunk=1024, pallas_bq=32),
                    capacity=n)
    idx.add(x)
    s, ids = idx.search(q, k, approx=True)
    rec = recall_at_k(np.asarray(ids), gt, k)
    assert rec >= 0.95, rec
    # scores are exact f32 (rescored), not bf16 scan values
    d0 = ((q[0] - x[np.asarray(ids)[0, 0]]) ** 2).sum()
    np.testing.assert_allclose(np.asarray(s)[0, 0], d0, rtol=1e-4)


@pytest.mark.gpu
def test_compiled_kernel_matches_reference(on_gpu):
    """The kernel as compiled for the card equals the plain jnp reference
    (both bf16 operands with f32 accumulation; they differ only in
    summation order, hence the tolerance)."""
    from zvdb_tpu.ops.flat_scan import flat_scan_bins_reference

    x, q = _mk(70_000, 128, 256, seed=6)
    norms = D.sq_norms(jnp.asarray(x))
    ks, ki = flat_scan_bins(jnp.asarray(q), jnp.asarray(x), norms)
    rs, ri = flat_scan_bins_reference(jnp.asarray(q), jnp.asarray(x), norms)
    np.testing.assert_allclose(np.asarray(ks), np.asarray(rs), rtol=1e-5,
                               atol=1e-3)
    assert np.mean(np.asarray(ki) == np.asarray(ri)) > 0.999
