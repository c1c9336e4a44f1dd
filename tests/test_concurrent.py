"""Concurrent search-DURING-insert for the graph engines (VERDICT r3 gap).

The reference serializes everything behind a global mutex
(src/hnsw.zig:74,195) and its concurrency test only interleaves inserts
(src/test_hnsw.zig:154-209). The batched engines promise more: mutations are
serialized behind host-side locks, while searches are lock-free reads of an
immutable pytree snapshot — so a search racing an insert must always see
SOME consistent prior state: valid ids, finite scores for returned rows,
never a crash or a torn read. These tests interleave real threads doing
inserts, searches, and removes simultaneously and assert exactly that, then
verify nothing was lost once the dust settles.
"""
import threading

import numpy as np
import pytest

from zvdb_tpu import (CagraConfig, CagraIndex, HNSW, HNSWConfig)

# compile-heavy multi-device tier — deselect with -m 'not slow' (fast gate)
pytestmark = pytest.mark.slow


def _run_interleaved(idx, x_build, x_stream, q, known_ids):
    """Insert x_stream in batches from 2 writer threads while 4 reader
    threads hammer search() and one thread removes a few rows. Returns
    collected errors and a sample of mid-stream search results."""
    errs = []
    seen = []
    stop = threading.Event()

    def writer(part):
        try:
            for lo in range(0, part.shape[0], 64):
                idx.add(part[lo:lo + 64])
        except Exception as e:  # pragma: no cover
            errs.append(("writer", e))

    def reader():
        try:
            while not stop.is_set():
                s, i = idx.search(q, 5)
                s, i = np.asarray(s), np.asarray(i)
                assert s.shape == (q.shape[0], 5)
                # returned ids are valid or -1; finite score iff real id
                assert ((i >= -1)).all()
                assert np.isfinite(s[i >= 0]).all()
                seen.append(i)
        except Exception as e:  # pragma: no cover
            errs.append(("reader", e))

    def remover():
        try:
            idx.remove(known_ids[:2])
        except Exception as e:  # pragma: no cover
            errs.append(("remover", e))

    halves = np.array_split(x_stream, 2)
    ws = [threading.Thread(target=writer, args=(h,)) for h in halves]
    rs = [threading.Thread(target=reader) for _ in range(4)]
    rm = threading.Thread(target=remover)
    for t in rs:
        t.start()
    for t in ws:
        t.start()
    rm.start()
    for t in ws + [rm]:
        t.join()
    stop.set()
    for t in rs:
        t.join()
    return errs, seen


@pytest.mark.parametrize("engine", ["hnsw", "cagra"])
def test_graph_search_during_insert(rng, engine):
    n0, ns, d = 2000, 1000, 16
    x = rng.standard_normal((n0 + ns, d)).astype(np.float32)
    q = x[:8] + 0.01
    if engine == "hnsw":
        idx = HNSW(HNSWConfig(dim=d, m=8, build_batch=256))
    else:
        idx = CagraIndex(CagraConfig(dim=d, degree=16))
    idx.build(x[:n0])
    errs, seen = _run_interleaved(idx, x[:n0], x[n0:], q,
                                  known_ids=[10, 11])
    assert not errs, errs
    assert len(seen) > 0
    # no lost points: every id present and searchable afterwards
    assert len(idx) == n0 + ns - 2
    if hasattr(idx, "flush"):
        idx.flush()
    # Two racing writers assign ids in ARRIVAL order, so x[r] does not land
    # at id r — every probe below is id-agnostic (a self-query must return a
    # squared-L2 score of ~0 for its top hit; the vectors are unique).
    tail = x[n0 + ns - 32:]
    # (1) Deterministic "no lost data": the filtered search routes to the
    # exact masked scan (round-4 policy), so allowing ALL ids is an exact
    # full scan — independent of graph edge quality. Every late row must be
    # stored somewhere.
    s, _ = idx.search(tail, 1, allowed=np.arange(n0 + ns))
    assert np.asarray(s).max() < 1e-3, "a late insert was lost"
    # (2) Beam reachability as a POPULATION contract: single late rows on an
    # adversarially interleaved incremental graph can need unbounded ef (the
    # thread-scheduling-dependent insert order decides their edge quality),
    # so a one-row probe is inherently flaky. Probing the whole late tail at
    # a raised ef asserts the graph didn't lose a cohort while tolerating a
    # stray hard-to-route node.
    s, _ = idx.search(tail, 10, ef_search=512)
    hit = float(np.mean(np.asarray(s)[:, 0] < 1e-3))
    assert hit >= 0.9, f"late-tail beam reachability {hit:.2f} < 0.9"
    # removed rows stay removed
    _, i = idx.search(x[10][None], 10)
    assert 10 not in np.asarray(i)[0].tolist()
    # mid-stream snapshots only ever surfaced valid ids
    total = n0 + ns
    for snap in seen[:: max(1, len(seen) // 16)]:
        assert (snap < total).all()
