"""zvdb-tpu quickstart: build, search, persist, serve — all four engines.

Run:  python examples/quickstart.py   (the GPU if JAX finds one; JAX_PLATFORMS=cpu for the CPU)
"""
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from zvdb_tpu import (
    CagraConfig, CagraIndex, FlatConfig, FlatIndex, HNSW, HNSWConfig,
    IVFConfig, IVFIndex, SearchServer, exact_ground_truth,
)

rng = np.random.default_rng(0)
N, D, K = 20_000, 64, 10
centers = rng.standard_normal((200, D)).astype(np.float32)
x = (centers[rng.integers(0, 200, N)]
     + 0.15 * rng.standard_normal((N, D))).astype(np.float32)
q = (x[rng.integers(0, N, 100)]
     + 0.05 * rng.standard_normal((100, D))).astype(np.float32)
_, gt = exact_ground_truth(x, q, K)


def recall(ids):
    ids = np.asarray(ids)
    return np.mean([len(set(ids[r]) & set(gt[r])) / K for r in range(len(ids))])


# --- graph engine (reference-parity HNSW) ----------------------------------
hnsw = HNSW(HNSWConfig(dim=D, m=16, ef_construction=100))
hnsw.build(x)
_, ids = hnsw.search(q, K, ef_search=64)
print(f"hnsw   recall@{K}: {recall(ids):.3f}")

hnsw.insert(rng.standard_normal(D).astype(np.float32))   # incremental insert
tmp = tempfile.mkdtemp()
hnsw.save(os.path.join(tmp, "quickstart_hnsw.npz"))
reloaded = HNSW.load(os.path.join(tmp, "quickstart_hnsw.npz"))
assert len(reloaded) == N + 1

# --- CAGRA (the fast graph engine: single layer, anchor-seeded beams) ------
cagra = CagraIndex(CagraConfig(dim=D, degree=32))
cagra.build(x)
_, ids = cagra.search(q, K, ef_search=16)
print(f"cagra  recall@{K}: {recall(ids):.3f}")

# --- brute-force engine (dense matmul scoring + approx top-k) --------------
flat = FlatIndex(FlatConfig(dim=D, precision="high"), capacity=N)
flat.add(x)
_, ids = flat.search(q, K, approx=True)
print(f"flat   recall@{K}: {recall(ids):.3f}")

# --- IVF engine (cluster-blocked grouped scan) ------------------------------
ivf = IVFIndex(IVFConfig(dim=D, n_clusters=128, nprobe=8))
ivf.build(x)
_, ids = ivf.search(q, K)
print(f"ivf    recall@{K}: {recall(ids):.3f}")

# --- serving: concurrent callers coalesced into device batches --------------
with SearchServer(flat, k=K, max_batch=256, max_wait_ms=2.0) as srv:
    s, i = srv.search(q[0])
    print(f"server top-1 id {int(i[0])}, score {float(s[0]):.4f}")
