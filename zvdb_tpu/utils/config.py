"""Configuration dataclasses for the engines.

The reference hardcodes every parameter at each construction site
(`benchmarks/shared_benchmarks.zig:62,91`, `src/test_hnsw.zig:26`); this module is
the config/flag system the reference lacks (SURVEY.md §5).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp

Metric = str  # "l2" | "dot" | "cosine"

_VALID_METRICS = ("l2", "dot", "cosine")

# Per-block candidate selection of the graph build (knn_graph._block_knn_scatter).
BLOCK_TOPK_MODES = ("exact", "approx", "binfold")



def config_from_dict(cls, d: dict):
    """Rebuild a config dataclass from a saved dict, dropping keys the class
    no longer has (options that were removed), so older snapshots load."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})


@dataclasses.dataclass(frozen=True)
class HNSWConfig:
    """Parameters for the HNSW index.

    Mirrors the reference constructor `HNSW(T).init(allocator, m, ef_construction)`
    (reference src/hnsw.zig:52) but with the parameters the reference stored and never
    used made real: `ef_construction` actually drives the build beam width, and
    `ef_search` (absent in the reference, which terminates after popping k) is a real
    search-time beam.
    """

    dim: int
    m: int = 16                    # max neighbors per node per upper layer
    ef_construction: int = 100     # build-time beam width (candidate pool per insert)
    metric: Metric = "l2"
    # Degree of the base layer; canonical HNSW uses 2*M. None -> 2*m.
    m0: Optional[int] = None
    # Level sampling uses canonical mL = 1/ln(m) (the reference uses p=0.5 ==
    # mL=1/ln 2, a known deviation — SURVEY.md §2.1 item 3). Override if needed.
    ml: Optional[float] = None
    # Hard cap on hierarchy height. None -> derived from capacity at build time.
    max_level: Optional[int] = None
    # Diversity pruning relaxation (alpha >= 1.0; 1.0 = strict RNG rule).
    alpha: float = 1.0
    # Storage dtype for vectors: float32 | bfloat16 | int8 (per-tensor
    # symmetric codes + one scalar dequant scale in HNSWState.q_scale — the
    # analog of the reference's HNSW(i32) instantiation, src/test_hnsw.zig:239).
    dtype: str = "float32"
    # Build batch size for bulk construction.
    build_batch: int = 1024
    # Beam width used for the upper-layer candidate searches during build.
    ef_construction_upper: int = 32
    # Matmul precision for distance computations (a jax.default_matmul_precision
    # name). bf16-input matmuls have ~4e-3 relative error, which swamps
    # neighbor-distance gaps on concentrated data and craters recall.
    # "high" is the engines' default (see ops/distance.py for what it lowers
    # to); "float32"/"highest" = exact f32; "default" = the platform's fastest
    # (LOSSY — avoid for scoring).
    precision: str = "high"
    # Build-time beam batched-expansion width (candidates expanded per hop).
    # 8 measured ~25% faster builds than 4 at equal recall (fewer, fatter hops).
    build_expand: int = 8
    # Cap on the candidate pool entering diversity pruning (the O(C^2 D)
    # pairwise matmul dominates build time). 0 = no cap. Measured: capping to
    # 64 costs ~6 points of recall@10 — the RNG rule genuinely selects distant
    # candidates for direction diversity — so the cap is off by default; use it
    # only when build time matters more than graph quality.
    select_cap: int = 0
    # Reorder base-layer rows diversity-first after bulk build (one cheap
    # matmul pass) so truncated-degree search (SearchConfig.search_degree) traverses
    # a diverse subgraph instead of intra-cluster edges only. Measured
    # (round 2, 100k x 128d): with search_degree=24 this lifts search 21.5k
    # -> 32.9k QPS at 0.9985 recall — on by default.
    diverse_rows: bool = True
    # Bulk-build strategy. "oneshot": whole graph from dense matmuls (cluster
    # kNN base layer + exact upper layers — build.bulk_build_oneshot; ~25x
    # faster, equal-or-better recall). "batched": frozen-prefix beam batches
    # (supports mid-build checkpoint/resume). "auto": oneshot unless
    # checkpointing was requested.
    build_mode: str = "auto"
    # Run a full beam search at every upper layer during build (canonical but
    # slow: one while_loop per layer per batch). Off = greedy descent only;
    # upper-layer edges come from level-filtered base candidates + intra-batch.
    # Upper layers only route searches, so the quality cost is tiny and the
    # build-time win is large (one beam search per batch instead of L+1).
    upper_beam: bool = False
    # Oneshot-build cost knobs (knn_graph.build_knn_graph), chosen for build
    # speed at equal recall against (exact top-k, kc=degree, no cap, 5 Lloyd
    # iters) at 100k x 128d clustered; not yet measured on the H100.
    kc_per_view: int = 16         # candidates kept per clustering view
    prune_cap: int = 64           # merged-pool cap entering diversity pruning
    block_topk: str = "approx"    # per-block top-k: one of BLOCK_TOPK_MODES
    build_kmeans_iters: int = 3

    def __post_init__(self):
        if self.metric not in _VALID_METRICS:
            raise ValueError(f"metric must be one of {_VALID_METRICS}, got {self.metric!r}")
        if self.dim <= 0:
            raise ValueError("dim must be positive")
        if self.m < 2:
            raise ValueError("m must be >= 2")
        if self.block_topk not in BLOCK_TOPK_MODES:
            raise ValueError(f"block_topk must be one of {BLOCK_TOPK_MODES}, "
                             f"got {self.block_topk!r}")

    @property
    def base_degree(self) -> int:
        return self.m0 if self.m0 is not None else 2 * self.m

    @property
    def storage_dtype(self):
        return {
            "float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8,
        }[self.dtype]

    @property
    def packed(self) -> bool:
        """One-gather packed (vector ‖ squared-norm) search layout, same as
        CagraConfig.packed: l2 + f32 only (bf16 would round the norm column;
        int8 codes cannot carry an f32 norm). Fusing the two per-hop row
        gathers into one halves the gathers per hop."""
        return self.metric == "l2" and self.dtype == "float32"


@dataclasses.dataclass(frozen=True)
class PQConfig:
    """Product-quantized flat index config (index/pqflat.py, ops/pq.py).

    The memory-scaling engine: n_sub/2 bytes/vector of nibble-packed 4-bit
    PQ codes (vs D bytes int8, 4D bytes f32), scanned by the XLA decode-tile
    scan, then an int16 refine rerank at rerank=12 — (n_sub/2 + 2*dim + 8)
    bytes/vector. The defaults were chosen at 1M x 128d; not yet measured
    on the H100. refine="int8" is the max-compression option
    (n_sub/2 + dim + 8; near-tie rescore flips cost recall); refine="none"
    is the pure-codes floor (recall bounded by quantization error; measure
    before choosing). n_codes=256 restores classic one-byte codes."""

    dim: int
    metric: Metric = "l2"
    # Subspace count: codes are n_sub bytes/vector (n_sub/2 when nibble-packed,
    # see n_codes). More subspaces = finer quantization = better recall,
    # linearly more memory. dsub = dim/n_sub of 8 is the classic operating
    # point for 8-bit codes; 4-bit codes pair with dsub of 4 (n_sub = dim/4).
    n_sub: int = 16
    # Codewords per subspace. <= 16 stores two codes per byte (nibble-packed
    # — half the memory); 256 keeps classic one-byte codes. The recall lost
    # to coarser codewords is made back with more subspaces, and with the
    # int16 refine store the rescore is exact.
    n_codes: int = 16
    # Corpus rows per scan tile: the decode step materializes a
    # [tile, n_sub, n_codes] one-hot block (tile=16384, S=16, C=256 ->
    # 268 MB f32), so the tile bounds it.
    tile_n: int = 16384
    # Matmul precision for scoring decoded tiles ("highest"|"high"|"default").
    # PQ reconstruction error dominates bf16 matmul noise only for coarse
    # codes; "high" is safe everywhere.
    precision: str = "high"
    # Selection recall floor for the approx top-k scan pass.
    recall_target: float = 0.95
    # Refine store for the exact rerank pass: "int16" (2D+4 bytes/vector —
    # per-vector symmetric quantization at +-32767 levels, ~2^-15 relative
    # error, f32-grade rescoring), "bfloat16" (2D), "float32" (4D, exact),
    # "int8" (D+4, max compression), "none" (codes only).
    refine: str = "int16"
    # Candidates per result entering the refine rerank (refine != "none").
    rerank: int = 12
    # Codebook training: sample size and Lloyd iterations. Codebooks are
    # trained once on the first build/add and FROZEN; later adds encode
    # against them (re-training would re-encode the whole corpus).
    train_sample: int = 32768
    kmeans_iters: int = 8
    # OPQ: learn an orthogonal rotation before the subspace split
    # (alternating Lloyd + Procrustes, ops/pq.py:train_opq). Costs one
    # [B, D]x[D, D] matmul per query batch and per ingest batch — noise next
    # to the scan — and lifts pure-codes recall when coordinates are
    # correlated across subspace boundaries; the refine rerank still runs in
    # the ORIGINAL space, so refine!="none" results stay exact-rescored.
    opq: bool = False
    # Procrustes alternations. Each runs 4 Lloyd iterations + one [D, D]
    # SVD; the final codebooks get the full kmeans_iters polish.
    opq_iters: int = 8
    seed: int = 0

    def __post_init__(self):
        if self.metric not in _VALID_METRICS:
            raise ValueError(f"metric must be one of {_VALID_METRICS}, got {self.metric!r}")
        if self.dim <= 0:
            raise ValueError("dim must be positive")
        if self.dim % self.n_sub != 0:
            raise ValueError(
                f"dim ({self.dim}) must be divisible by n_sub ({self.n_sub})")
        if not 2 <= self.n_codes <= 256:
            raise ValueError("n_codes must be in [2, 256] (codes are uint8)")
        if self.refine not in ("none", "int8", "int16", "float32",
                               "bfloat16"):
            raise ValueError(f"invalid refine {self.refine!r}")

    @property
    def packed(self) -> bool:
        """Nibble-packed code storage (two 4-bit codes per byte, stored
        transposed [n_sub/2, cap])."""
        return self.n_codes <= 16 and self.n_sub % 2 == 0

    @property
    def codes_width(self) -> int:
        return self.n_sub // 2 if self.packed else self.n_sub

    @property
    def dsub(self) -> int:
        return self.dim // self.n_sub

    @property
    def refine_dtype(self):
        return {"int8": jnp.int8, "int16": jnp.int16, "float32": jnp.float32,
                "bfloat16": jnp.bfloat16, "none": jnp.float32}[self.refine]

    @property
    def bytes_per_vector(self) -> int:
        """Device bytes per vector (codes + norm + refine store)."""
        refine = {"none": 0, "int8": self.dim + 4, "int16": 2 * self.dim + 4,
                  "float32": 4 * self.dim, "bfloat16": 2 * self.dim}[self.refine]
        return self.codes_width + 4 + refine


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Search-time knobs (the reference has none: no ef_search, k-pop termination —
    reference src/hnsw.zig:211)."""

    ef_search: int = 64
    # Number of beam entries expanded per hop (batched expansion): fewer,
    # fatter hops (each while_loop iteration costs
    # fixed latency; expanding 8 at once cuts hop count ~8x for a small
    # extra-candidate cost).
    expand: int = 8
    # Max hops in the layer-0 beam loop; None -> derived (ef/expand + 8, see
    # hnsw.beam_layer_fn), which scales with ef_search. A FIXED small cap is faster on clustered
    # data (anchor seeds converge in 4-6 hops) but silently caps recall when
    # the user raises ef on hard/uniform data (measured: -7 recall points at
    # ef=128 with a cap of 8) — so the default derives from ef.
    max_iters: Optional[int] = None
    # Max greedy hops per upper layer.
    max_upper_iters: int = 32
    # Use only the first `search_degree` neighbors of each expanded node;
    # None = full row. Requires diversity-first row order to be safe:
    # truncating NEAREST-first rows strips exactly the inter-cluster edges
    # and recall collapses (round-1 measured 0.95 -> 0.32 at degree 16).
    # With HNSWConfig.diverse_rows (now default) the first slots are the
    # RNG-kept diverse edges, and 24/32 costs -0.0002 recall for +50% QPS.
    # Ignored when >= the row degree.
    search_degree: Optional[int] = 24
    # Exact in-hop candidate dedupe (O(C^2) bool matrix per hop — GBs at large
    # batch). Off trades a little beam capacity for much cheaper hops; final
    # results are always deduped either way.
    dedupe_candidates: bool = True
    # Anchor rows unioned into the layer-0 beam seeds (one [B, A] matmul
    # against the index's dense anchor table; 0 = descent-only seeding).
    # Greedy descent alone strands on micro-clustered data (measured ~0.63
    # recall ceiling); the best of ~n/12 random anchors is ~the 12th-nearest
    # neighbor, so anchor seeds start the beam inside the answer's
    # neighborhood. No effect when the index carries no anchor table.
    seed_anchors: int = 16


@dataclasses.dataclass(frozen=True)
class FlatConfig:
    """Brute-force index config."""

    dim: int
    metric: Metric = "l2"
    dtype: str = "float32"
    # Tile size over the corpus axis for memory-bounded exact search.
    tile_n: int = 131072
    # Matmul precision for scoring: "highest" (exact-oracle), "high",
    # "default" (the platform's fastest — lossy; pairs with bfloat16 storage).
    precision: str = "highest"
    # Selection recall floor for the approximate top-k path (search(approx=True)).
    recall_target: float = 0.95
    # Approximate-scan implementation for search(approx=True):
    #   "xla"    — lax.scan over corpus tiles + lax.approx_min_k (default).
    #   "pallas" — fused kernel (ops/flat_scan.py, Pallas on the Triton
    #              route): scoring + per-segment bin fold on chip, so the
    #              [B, tile] scores never reach device memory. f32/bf16
    #              storage only (int8 and filtered search take the xla path).
    scan: str = "xla"
    # Fused path: bins per corpus segment (each keeps its best two rows),
    # corpus rows per segment (one program's share) and queries per
    # program. Powers of two; the fastest tiling measured at 1M x 128d,
    # B = 2048 on the H100 (PERF.md).
    l_bins: int = 64
    pallas_chunk: int = 16384
    pallas_bq: int = 128
    # Two-pass approx search: scan at `scan_precision` keeping rerank*k
    # candidates, then rescore them against the stored vectors at full
    # precision (one small gather). Lets the scan matmul run at the bf16
    # rate ("default") without the bf16 recall cliff — the exact rerank
    # repairs the ranking. 0 = off.
    rerank: int = 0
    scan_precision: str = "default"
    # PCA-filtered first pass (pHNSW/AQR-style, PAPERS.md): project the
    # approx scan into the corpus's top pca_dim principal subspace (one
    # [B,D]x[D,p] matmul for queries; projected corpus kept as derived
    # state) and rerank the survivors exactly in full dimension. Cuts the
    # dominant [B,N]xD scan matmul by D/pca_dim — a high-dim (768/1024d)
    # lever; pointless at 128d. Requires rerank > 0; takes the XLA scan
    # path. 0 = off.
    pca_dim: int = 0

    def __post_init__(self):
        if self.metric not in _VALID_METRICS:
            raise ValueError(f"metric must be one of {_VALID_METRICS}, got {self.metric!r}")
        if self.scan not in ("xla", "pallas"):
            raise ValueError(f"scan must be 'xla' or 'pallas', got {self.scan!r}")

    @property
    def storage_dtype(self):
        # int8: symmetric per-vector quantized codes + f32 scales (state.scales)
        return {
            "float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8,
        }[self.dtype]
