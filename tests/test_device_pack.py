"""Device-side block pack (knn_graph._pack_core) vs the host reference pack.

The device pack exists for throughput (the host lexsort costs seconds at
1M x spill 2 and the packed tables must then be re-uploaded), but
it must be a drop-in: identical block tables, identical overflow handling,
identical final graphs. reference src/hnsw.zig has no bulk build at all —
this pins OUR invariant that the two pack implementations are interchangeable.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zvdb_tpu.index.knn_graph import _pack_blocks, _pack_core, build_knn_graph


@pytest.mark.parametrize("seed,n,c,bcap", [(0, 5000, 37, 160), (3, 997, 11, 96)])
def test_pack_core_matches_host(seed, n, c, bcap):
    rng = np.random.default_rng(seed)
    spill = 2
    assign = rng.integers(0, c, (n, spill)).astype(np.int32)
    assign[: n // 3, 0] = 0          # force cluster-0 overflow -> missing pts
    hp, ho, _ = _pack_blocks(assign, c, bcap)
    bp, bo, nm, morder = _pack_core(jnp.asarray(assign), c, bcap, spill)
    bp, bo, nm, morder = map(np.asarray, (bp, bo, nm, morder))
    if nm > 0:
        mm = morder[:nm].astype(np.int32)
        rows = -(-int(nm) // bcap)
        extra = np.full((rows, bcap), -1, np.int32)
        extra.reshape(-1)[: nm] = mm
        bp = np.concatenate([bp, extra], axis=0)
        bo = np.concatenate([bo, np.zeros((rows, bcap), np.int32)], axis=0)
    np.testing.assert_array_equal(bp, hp)
    np.testing.assert_array_equal(bo, ho)


def test_device_pack_graph_identical():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3000, 16)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    g_dev = build_knn_graph(x, 16, key, block=256, pack="device")
    g_host = build_knn_graph(x, 16, key, block=256, pack="host")
    for a, b in zip(g_dev, g_host):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype.kind == "f":
            assert np.array_equal(a, b, equal_nan=True)
        else:
            np.testing.assert_array_equal(a, b)
