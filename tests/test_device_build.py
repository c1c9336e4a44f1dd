"""Device-resident corpus builds (IVF / HNSW oneshot): same quality as the
host-numpy path, no host round-trip.

Round-3 regression: HNSW.build pulled jax-array corpora to the host before
dispatching (hnsw.py build np.asarray), and the IVF <500k device path pulled
oversized-cluster rows through per-shape gathers that minted a fresh compile
each. Device corpora now route
through the oneshot device branch / the batched device split.
"""
import jax
import numpy as np
import pytest

from zvdb_tpu import HNSW, HNSWConfig, IVFConfig, IVFIndex


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(3)
    cents = rng.standard_normal((40, 24)).astype(np.float32) * 5
    x = (cents[rng.integers(0, 40, 4000)]
         + rng.standard_normal((4000, 24)).astype(np.float32))
    return x


def _self_hit(idx, x, **kw):
    ids = np.asarray(idx.search(x[:200], 1, **kw)[1])
    return (ids[:, 0] == np.arange(200)).mean()


def test_ivf_device_build_matches_host(corpus):
    x = corpus
    cfg = IVFConfig(dim=24, n_clusters=64, nprobe=8)
    host = IVFIndex(cfg)
    host.build(x)
    dev = IVFIndex(cfg)
    dev.build(jax.device_put(x))
    # split init differs between the host and batched-device paths, so ids
    # can differ on near-ties — compare retrieval quality, not bit layout
    assert _self_hit(dev, x) >= _self_hit(host, x) - 0.01
    assert _self_hit(dev, x) > 0.97


def test_hnsw_oneshot_device_build_matches_host(corpus):
    x = corpus
    cfg = HNSWConfig(dim=24, m=8, build_mode="oneshot")
    host = HNSW(cfg)
    host.build(x)
    dev = HNSW(cfg)
    dev.build(jax.device_put(x))
    assert _self_hit(dev, x, ef_search=32) >= _self_hit(host, x, ef_search=32) - 0.01
    assert _self_hit(dev, x, ef_search=32) > 0.95


def test_hnsw_device_build_cosine_int8(corpus):
    x = corpus
    for kw in (dict(metric="cosine"), dict(dtype="int8")):
        idx = HNSW(HNSWConfig(dim=24, m=8, build_mode="oneshot", **kw))
        idx.build(jax.device_put(x))
        assert _self_hit(idx, x, ef_search=32) > 0.9
