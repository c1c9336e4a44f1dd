"""Cluster-grouped ADC scan (ops/pq_grouped.py) against a float64 numpy
reference, and the IVF-PQ engine paths around it: empty query slots, cap
padding, cluster-group chunking, position -> id mapping with tombstones.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zvdb_tpu.ops import pq as PQ
from zvdb_tpu.ops import pq_grouped as G

C, CAP, NB, B, QCAP = 3, 300, 4, 10, 8     # n_sub = 2 * NB


def _inputs(seed=0, cap=CAP):
    rng = np.random.default_rng(seed)
    n_sub = 2 * NB
    lut = rng.standard_normal((B, n_sub, 16)).astype(np.float32)
    codes = rng.integers(0, 16, (C, cap, n_sub)).astype(np.uint8)
    packed = np.asarray(PQ.pack_nibbles(jnp.asarray(
        codes.reshape(-1, n_sub)))).reshape(C, cap, NB).transpose(0, 2, 1)
    norms = rng.uniform(1.0, 3.0, (C, cap)).astype(np.float32)
    norms[0, 5] = np.inf                         # a tombstoned row
    qslot = np.full((C, QCAP), -1, np.int32)
    for c in range(C):
        qslot[c, : 4 + c] = rng.permutation(B)[: 4 + c]
    return lut, codes, packed, norms, qslot


def _reference(lut, codes, norms, qslot, metric, l_bins, per_bin, capp):
    """float64 ADC scores, then per-bin best (and runner-up) by brute force.
    Returns ([C, QCAP, per_bin, L] scores, positions) with +inf / -1."""
    factor = 2.0 if metric == "l2" else 1.0
    out_s = np.full((C, QCAP, per_bin, l_bins), np.inf)
    out_p = np.full((C, QCAP, per_bin, l_bins), -1)
    l64 = lut.astype(np.float64)
    for c in range(C):
        dots = l64[:, np.arange(codes.shape[2]), codes[c]].sum(-1)  # [B, cap]
        for sl in range(QCAP):
            qi = qslot[c, sl]
            if qi < 0:
                continue
            s = np.full(capp, np.inf)
            s[: codes.shape[1]] = norms[c].astype(np.float64) - factor * dots[qi]
            for lane in range(l_bins):
                rows = np.arange(lane, capp, l_bins)
                order = rows[np.argsort(s[rows], kind="stable")]
                for r in range(per_bin):
                    if r < len(order) and np.isfinite(s[order[r]]):
                        out_s[c, sl, r, lane] = s[order[r]]
                        out_p[c, sl, r, lane] = order[r]
    return out_s, out_p


def _split(x, per_bin, l_bins):
    return np.asarray(x).reshape(C, QCAP, per_bin, l_bins)


@pytest.mark.parametrize("per_bin", [1, 2])
@pytest.mark.parametrize("metric", ["l2", "dot", "cosine"])
def test_grouped_scan_matches_f64_reference(metric, per_bin):
    """Every bin's kept scores equal the float64 per-bin minimum (and
    runner-up), and every kept position scores that value (ties aside)."""
    lut, codes, packed, norms, qslot = _inputs()
    l_bins, chunk = 64, 128
    bs, bp = G.pq_grouped_scan_bins(
        jnp.asarray(lut), jnp.asarray(qslot), jnp.asarray(packed),
        jnp.asarray(norms), l_bins=l_bins, chunk=chunk, metric=metric,
        precision="high", per_bin=per_bin)
    _, capp = G.grouped_geometry(CAP, l_bins, chunk)
    assert bs.shape == (C, QCAP, per_bin * l_bins) == bp.shape
    rs, rp = _reference(lut, codes, norms, qslot, metric, l_bins, per_bin,
                        capp)
    ks, kp = _split(bs, per_bin, l_bins), _split(bp, per_bin, l_bins)
    live = np.isfinite(rs)
    assert np.array_equal(live, np.isfinite(ks))
    assert np.array_equal(live, kp >= 0)
    # hi/lo bf16 table: ~2^-16 relative per term over 2*NB terms
    tol = 1e-3
    np.testing.assert_allclose(ks[live], rs[live], atol=tol)
    # positions: same row, or a row scoring the same within tolerance
    same = kp == rp
    assert same[live].mean() > 0.95
    assert kp[live].max() < CAP and 5 not in set(kp[0][live[0]].tolist())


@pytest.mark.parametrize("precision,tol", [
    ("high", 1e-3),       # hi/lo split: ~2^-16 relative per table entry
    ("default", 0.1),     # one bf16 pass: 2^-8 relative per entry
    ("int8", 0.1),        # per-query scale max|lut|/127, half a step each
])
def test_grouped_scan_precisions(precision, tol):
    """Each LUT precision stays within its quantization envelope of the
    float64 reference (bin minima compared; 2*NB table entries per row)."""
    lut, codes, packed, norms, qslot = _inputs(seed=1)
    bs, _ = G.pq_grouped_scan_bins(
        jnp.asarray(lut), jnp.asarray(qslot), jnp.asarray(packed),
        jnp.asarray(norms), l_bins=64, chunk=128, precision=precision,
        per_bin=1)
    _, capp = G.grouped_geometry(CAP, 64, 128)
    rs, _ = _reference(lut, codes, norms, qslot, "l2", 64, 1, capp)
    ks = _split(bs, 1, 64)
    live = np.isfinite(rs)
    assert np.abs(ks[live] - rs[live]).max() <= tol * 2 * NB


def test_empty_query_slots():
    """Slots with qslot < 0 return +inf / -1 in every column, whatever the
    codes; a cluster with no probing query returns only empties."""
    lut, _, packed, norms, qslot = _inputs(seed=2)
    qslot[1, :] = -1
    bs, bp = G.pq_grouped_scan_bins(
        jnp.asarray(lut), jnp.asarray(qslot), jnp.asarray(packed),
        jnp.asarray(norms), l_bins=64, chunk=128, per_bin=2)
    bs, bp = np.asarray(bs), np.asarray(bp)
    empty = qslot < 0
    assert np.isinf(bs[empty]).all() and (bp[empty] == -1).all()
    assert np.isfinite(bs[~empty]).any(axis=-1).all()


def test_cap_padding_to_chunk():
    """A cap that is no multiple of chunk pads with +inf rows: padded
    positions never surface, and the result equals the same blocks padded
    by hand."""
    lut, codes, packed, norms, qslot = _inputs(seed=3, cap=200)
    chunk, capp = G.grouped_geometry(200, 64, 128)
    assert (chunk, capp) == (128, 256)
    kw = dict(l_bins=64, chunk=128, per_bin=2)
    bs, bp = G.pq_grouped_scan_bins(
        jnp.asarray(lut), jnp.asarray(qslot), jnp.asarray(packed),
        jnp.asarray(norms), **kw)
    assert np.asarray(bp).max() < 200
    pk = np.pad(packed, ((0, 0), (0, 0), (0, capp - 200)))
    pn = np.pad(norms, ((0, 0), (0, capp - 200)), constant_values=np.inf)
    hs, hp = G.pq_grouped_scan_bins(
        jnp.asarray(lut), jnp.asarray(qslot), jnp.asarray(pk),
        jnp.asarray(pn), **kw)
    np.testing.assert_array_equal(np.asarray(bp), np.asarray(hp))
    np.testing.assert_array_equal(np.asarray(bs), np.asarray(hs))


def test_cluster_group_chunking_is_exact(monkeypatch):
    """Bounding the intermediate (clusters scanned in groups, the last one
    partial) changes nothing in the result."""
    lut, _, packed, norms, qslot = _inputs(seed=4)
    kw = dict(l_bins=64, chunk=128, per_bin=2)
    args = (jnp.asarray(lut), jnp.asarray(qslot), jnp.asarray(packed),
            jnp.asarray(norms))
    whole = G.pq_grouped_scan_bins(*args, **kw)
    monkeypatch.setattr(G, "_GROUP_BYTES", 1)      # one cluster per group
    jax.clear_caches()
    grouped = G.pq_grouped_scan_bins(*args, **kw)
    for a, b in zip(whole, grouped):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_position_to_id_mapping_with_tombstones():
    """Bin positions map to external ids through b_ids; tombstoned rows
    (-2-id) and padding never surface, and the survivors still self-hit."""
    from zvdb_tpu import IVFPQConfig, IVFPQIndex

    rng = np.random.default_rng(5)
    cents = rng.normal(size=(16, 32)).astype(np.float32)
    x = (cents[rng.integers(0, 16, 3000)]
         + 0.3 * rng.normal(size=(3000, 32))).astype(np.float32)
    idx = IVFPQIndex(IVFPQConfig(dim=32, n_sub=8, nprobe=4, rerank=8,
                                 train_sample=3000))
    idx.build(x)
    gone = np.arange(0, 3000, 3)
    idx.remove(gone)
    _, ids = idx.search(x[:300], 5)
    ids = np.asarray(ids)
    assert not np.isin(ids, gone).any()
    assert ids.max() < 3000
    live = np.setdiff1d(np.arange(300), gone)
    assert (ids[live, 0] == live).mean() > 0.9
