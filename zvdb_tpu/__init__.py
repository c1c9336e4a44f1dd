"""zvdb-tpu: a batched vector search engine in JAX.

Brand-new implementation of the capabilities of the reference `zvdb` Zig library
(an in-memory HNSW index — reference src/zvdb.zig:1, src/hnsw.zig:8-247),
re-architected for accelerators: flat int32 neighbor tables traversed by
batched beam search, matmul distances, bulk batched graph construction, and
shard_map sharding across device meshes.

Public surface (the reference exports exactly one symbol, `HNSW` —
src/zvdb.zig:1; we keep that plus the engine pieces around it):

    from zvdb_tpu import HNSW            # the graph index
    from zvdb_tpu import FlatIndex       # exact brute-force index / oracle
    from zvdb_tpu import HNSWConfig, SearchConfig, FlatConfig
"""

from .utils.config import FlatConfig, HNSWConfig, PQConfig, SearchConfig
from .index.flat import FlatIndex, exact_ground_truth
from .index.hnsw import HNSW, HNSWState
from .index.ivf import IVFConfig, IVFIndex
from .index.cagra import CagraConfig, CagraIndex
from .index.ivfpq import IVFPQConfig, IVFPQIndex
from .index.pqflat import PQFlatIndex
from .serve import SearchServer
from .utils.router import relative_contrast, suggest_engine

__all__ = [
    "HNSW",
    "HNSWState",
    "CagraIndex",
    "CagraConfig",
    "FlatIndex",
    "IVFIndex",
    "IVFConfig",
    "IVFPQIndex",
    "IVFPQConfig",
    "PQFlatIndex",
    "PQConfig",
    "exact_ground_truth",
    "HNSWConfig",
    "SearchConfig",
    "FlatConfig",
    "SearchServer",
    "relative_contrast",
    "suggest_engine",
]


def __getattr__(name):
    # sharded engines import lazily (they touch jax.sharding / mesh state)
    if name in ("ShardedHNSW", "ShardedFlat", "ShardedIVF", "ShardedCagra",
                "ShardedPQFlat", "ShardedIVFPQ", "make_mesh"):
        from .parallel.mesh import make_mesh
        from .parallel.sharded import ShardedHNSW
        from .parallel.sharded_cagra import ShardedCagra
        from .parallel.sharded_flat import ShardedFlat
        from .parallel.sharded_ivf import ShardedIVF
        from .parallel.sharded_ivfpq import ShardedIVFPQ
        from .parallel.sharded_pq import ShardedPQFlat

        return {
            "ShardedHNSW": ShardedHNSW,
            "ShardedFlat": ShardedFlat,
            "ShardedIVF": ShardedIVF,
            "ShardedCagra": ShardedCagra,
            "ShardedPQFlat": ShardedPQFlat,
            "ShardedIVFPQ": ShardedIVFPQ,
            "make_mesh": make_mesh,
        }[name]
    raise AttributeError(name)

__version__ = "0.1.0"
