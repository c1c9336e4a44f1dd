"""CAGRA-style single-layer graph engine — the fast graph index.

Rationale: hierarchical HNSW search on an accelerator is bound by random
row gathers, and the hierarchy's greedy descent spends those gathers on
routing instead of recall. This engine removes the hierarchy
entirely (like CAGRA does on GPU) and replaces it with:

  * a single fixed-degree diversity-pruned kNN graph (index/knn_graph.py —
    built from dense matmuls, no beam searches), and
  * anchor seeding: a random sample of ~n/12 corpus rows is kept as a dense
    [A, D] anchor table; one [B, A] matmul ranks all anchors per query
    and the beam starts at the best `n_seeds` anchor rows. The best of A
    random anchors is on the order of the (n/A)-th nearest neighbor, so the
    beam starts INSIDE the answer's neighborhood — measured on 10k-micro-
    cluster SIFT-like data, k-means-centroid seeding landed ~600x farther
    than the true NN and capped recall at ~0.7; anchor seeding restores the
    oracle-seeded recall. Matmul flops are the cheap resource; random row
    gathers are the expensive one — anchor seeding converts navigation
    hops (gathers) into one dense matmul.

The base-layer beam loop is shared with HNSW (hnsw.beam_layer_fn) through a
row-scoring closure. For l2 + float storage the closure uses a PACKED layout:
vectors and their squared norms live in one [N, D+1] table, so each hop costs
ONE row gather instead of two (vector + norm) — gathers are row-count-bound,
so this is ~2x the hop bandwidth of the HNSW layout.

Capability parity with the reference surface (src/hnsw.zig): insert (buffered
incremental extend), search, plus build/save/load/get and l2/dot/cosine.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import threading
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import distance as D
from ..ops import topk as T
from .hnsw import beam_layer_fn
from ..utils.config import BLOCK_TOPK_MODES
from .knn_graph import VecStore, build_knn_graph

INF = jnp.inf

# minimum host-corpus size for the segmented upload-overlap path when
# CagraConfig.upload_segments > 1 (tests shrink it to exercise the path on
# small CPU corpora). Off by default: whether the overlap pays over the
# GPU's PCIe link is not yet measured.
_OVERLAP_MIN_N = 1 << 16


@dataclasses.dataclass(frozen=True)
class CagraConfig:
    dim: int
    degree: int = 32              # fixed out-degree of the graph
    metric: str = "l2"
    dtype: str = "float32"        # float32 | bfloat16 | int8 (per-tensor codes)
    # --- construction (see knn_graph.build_knn_graph) ---
    # Fewer passes/spills build faster at lower recall. The default keeps
    # two independent clustering views: boundary-loss repair is what holds
    # recall up as N grows (not yet measured on the H100).
    block: int = 1024             # target cluster/block size
    spill: int = 2                # clusters each point joins per pass
    passes: int = 2               # independent clustering passes
    kmeans_iters: int = 3
    kmeans_sample: int = 65536    # Lloyd runs on this many sampled rows
    alpha: float = 1.2            # diversity-pruning relaxation
    precision: str = "high"
    seed_reps: int = 4            # representative rows kept per cluster
    n_long: int = 4               # random long-range edges per row
    # Build-cost knobs (knn_graph.build_knn_graph): candidates kept per view
    # (0 -> degree), merged-pool cap entering the O(C^2 D) diversity prune
    # (0 -> no cap), and exact vs hardware-approx per-block top-k. Measured
    # defaults: 2.5x faster build than (exact, kc=degree, no cap) at equal
    # or better recall (0.9989 vs 0.9982 @ ef=16, 100k x 128d clustered).
    kc_per_view: int = 16
    prune_cap: int = 64
    block_topk: str = "approx"    # one of BLOCK_TOPK_MODES
    # Anchor count for seed routing: 0 -> auto (~n/12, pow2-clamped to
    # [1024, 32768]). The [B, A] seed matmul is cheap; bigger A = closer
    # seeds = fewer beam hops (hops cost row gathers, the scarce resource).
    n_anchors: int = 0
    # --- search defaults ---
    ef_search: int = 32
    n_seeds: int = 16             # anchors seeding each query's beam
    expand: int = 4               # beam entries expanded per hop
    # Use only the first search_degree neighbors of each expanded row
    # (None = full row). Rows are diversity-ordered by construction
    # (select_neighbors emits RNG-kept edges first, distance-backfill last),
    # so truncation drops mostly backfill — unlike HNSW's distance-ordered
    # rows where it stripped the diversity edges (round-1 measured 0.95 ->
    # 0.32). Hop cost is gather-row-count-bound; measured at degree=32:
    # 24 costs -0.0002 recall for +23% QPS (131.8k @ 0.9979 with ef=12),
    # 16 costs ~-0.008 for +35%. Ignored when >= degree.
    search_degree: Optional[int] = 24
    # Hop budget. Anchor seeding starts the beam ~inside the answer's
    # neighborhood, so few hops are needed: measured on 100k x 128d clustered,
    # recall@10 is 0.994 after 2 hops, 0.998 after 4-6, flat afterwards —
    # while each extra hop costs ~1.7 us/query. None = derived ef/expand + 8
    # (hnsw.beam_layer_fn), which scales with ef_search (a fixed cap silently
    # limits quality when ef is raised on harder data).
    max_iters: Optional[int] = None
    # Select the n_seeds best anchors with the hardware partial top-k
    # (approx_min_k) instead of an exact sort: the [B, A] exact top_k is the
    # dominant FIXED cost per search (measured ~2.8 us/query at A=8192), and
    # seed selection needs no exactness — a 97%-quality seed set costs zero
    # end recall (the beam repairs it).
    seed_approx: bool = True
    # --- incremental insert ---
    build_batch: int = 2048
    ef_construction: int = 64
    seed: int = 0
    # Segmented upload-overlap build: >1 splits a HOST corpus into this many
    # device_put segments and runs pass-0 k-means/assignment on the landed
    # prefix while the rest transfers. 0 = off (default; see _OVERLAP_MIN_N).
    upload_segments: int = 0
    # Fat-row hop expansion: materialize each node's whole neighborhood
    # (deg x (vector | norm | id)) as ONE row of a [cap+1, deg*(D+2)] f32
    # table, so a hop gathers `expand` rows instead of `expand*degree`.
    # This trades (degree+1)x device memory for a ~degree-fold cut in
    # gathered rows; it pays only where gathers are row-count-bound rather
    # than bandwidth-bound (not yet measured on the H100). Default off.
    fat_rows: str = "off"         # "auto" | "on" | "off"
    fat_budget_bytes: int = 6 << 30

    def __post_init__(self):
        if self.metric not in ("l2", "dot", "cosine"):
            raise ValueError(f"bad metric {self.metric!r}")
        if self.dim <= 0:
            raise ValueError("dim must be positive")
        if self.block_topk not in BLOCK_TOPK_MODES:
            raise ValueError(f"block_topk must be one of {BLOCK_TOPK_MODES}, "
                             f"got {self.block_topk!r}")

    @property
    def storage_dtype(self):
        return {
            "float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8,
        }[self.dtype]

    @property
    def packed(self) -> bool:
        """One-gather packed (vector ‖ norm) search layout: l2 + f32 only.
        bf16 would round the norm column (±0.4% — swamps neighbor gaps);
        int8 codes cannot carry an f32 norm."""
        return self.metric == "l2" and self.dtype == "float32"


class CagraState(NamedTuple):
    vectors: jax.Array    # [cap, D] storage dtype (int8: codes)
    norms: jax.Array      # [cap] f32 (true squared norms for l2; zeros else)
    nbrs: jax.Array       # [cap+1, degree] int32, -1 padded (row cap = trash)
    dists: jax.Array      # [cap+1, degree] f32 edge distances (for extends)
    anchors: jax.Array    # [A, D] f32 dense copies of the anchor rows
    a_norms: jax.Array    # [A] f32
    a_rows: jax.Array     # [A] int32 row id of each anchor
    n: jax.Array          # scalar int32
    q_scale: jax.Array    # scalar f32 int8 dequant scale (1.0 otherwise)


class _SearchArrays(NamedTuple):
    """What the jitted search actually consumes. `table` is the packed
    [cap, D+1] layout when cfg.packed, else the raw vectors. `dead` is the
    tombstone mask ([cap] bool) or None when nothing was ever removed —
    deleted nodes stay in the graph as traversal waypoints and are filtered
    from the final beam only."""
    table: jax.Array
    norms: jax.Array
    nbrs: jax.Array
    anchors: jax.Array
    a_norms: jax.Array
    a_rows: jax.Array
    n: jax.Array
    q_scale: jax.Array
    dead: Optional[jax.Array] = None


def _pick_anchor_rows(key: jax.Array, n: int, n_anchors: int) -> jax.Array:
    """Random anchor rows: auto-size ~n/12, pow2-clamped to [1024, 32768]."""
    if n_anchors <= 0:
        n_anchors = 1 << max(10, min(15, int(math.ceil(math.log2(max(n, 2) / 12.0)))))
    a = min(n_anchors, max(n, 1))
    if a >= n:
        return jnp.arange(n, dtype=jnp.int32)
    return jax.random.choice(key, n, (a,), replace=False).astype(jnp.int32)


def _reseed_anchors(state: CagraState, n: int, key: jax.Array,
                    n_anchors: int) -> CagraState:
    """Resample the anchor table over the current row range [0, n).

    Anchor staleness: the seed table is sampled at build time, so an index
    grown well past its build size would seed every beam from the ORIGINAL
    corpus region only — inserted points become reachable solely through
    graph edges, and recall on them decays with the growth ratio. Callers
    refresh when n doubles past the last snapshot (cheap: one gather; the
    changed anchor-table shape recompiles the search program, which is why
    refreshes are geometric, not per-flush)."""
    a_rows = _pick_anchor_rows(key, n, n_anchors)
    anchors = jnp.take(state.vectors, a_rows, axis=0).astype(jnp.float32) \
        * state.q_scale
    a_norms = jnp.take(state.norms, a_rows)   # zeros already for dot/cosine
    return state._replace(anchors=anchors, a_norms=a_norms, a_rows=a_rows)


@jax.jit
def _build_fat_pack(vectors, norms, nbrs, q_scale):
    """[cap+1, deg*(D+2)] f32: per node, its neighbors' (vector‖norm‖id) rows
    concatenated. ids ride as f32 (exact for cap < 2^24); missing neighbors
    carry id -1 / norm +inf so their scores are +inf downstream."""
    safe = jnp.maximum(nbrs, 0)
    vx = jnp.take(vectors, safe.reshape(-1), axis=0).astype(jnp.float32)
    vx = (vx * q_scale).reshape(nbrs.shape[0], nbrs.shape[1], -1)
    nx = jnp.where(nbrs >= 0, jnp.take(norms, safe, axis=0), INF)
    ids = nbrs.astype(jnp.float32)
    pack = jnp.concatenate([vx, nx[..., None], ids[..., None]], axis=-1)
    return pack.reshape(nbrs.shape[0], -1)


def _make_fat_expander(arrs: _SearchArrays, qp: jax.Array, metric: str,
                       deg: int):
    """sel_r [B, E] -> (cand_ids [B, E*deg], scores [B, E*deg]) from ONE
    gather per selected row (arrs.table is the fat pack)."""
    width = arrs.table.shape[-1]
    dp2 = width // deg
    d = dp2 - 2
    factor = 2.0 if metric == "l2" else 1.0

    def expand_fn(sel_r):
        b, e = sel_r.shape
        fat = jnp.take(arrs.table, jnp.maximum(sel_r, 0), axis=0)
        fat = fat.reshape(b, e * deg, dp2)
        vx = fat[..., :d]
        nx = fat[..., d]
        ids = fat[..., d + 1].astype(jnp.int32)
        sel_ok = jnp.repeat(sel_r >= 0, deg, axis=1)
        ids = jnp.where(sel_ok, ids, -1)
        dots = jnp.einsum("bd,bcd->bc", qp, vx,
                          preferred_element_type=jnp.float32)
        s = jnp.where(ids >= 0, nx - factor * dots, INF)
        ids = jnp.where(jnp.isfinite(s), ids, -1)
        return ids, s

    return expand_fn


def _make_scorer(arrs: _SearchArrays, qp: jax.Array, metric: str, packed: bool):
    """rows [B, C] -> surrogate scores [B, C]."""
    if packed:
        # score = ||x||^2 - 2 q.x = -2 * ([q, -0.5] . [x, ||x||^2])
        b = qp.shape[0]
        qe = jnp.concatenate([qp, jnp.full((b, 1), -0.5, jnp.float32)], axis=1)

        def score_rows(rows):
            safe = jnp.maximum(rows, 0)
            vx = jnp.take(arrs.table, safe, axis=0)            # ONE gather
            dots = jnp.einsum("bd,bcd->bc", qe, vx,
                              preferred_element_type=jnp.float32)
            return jnp.where(rows >= 0, -2.0 * dots, INF)

        return score_rows

    def score_rows(rows):
        safe = jnp.maximum(rows, 0)
        vx = jnp.take(arrs.table, safe, axis=0).astype(jnp.float32)
        dots = jnp.einsum("bd,bcd->bc", qp, vx,
                          preferred_element_type=jnp.float32) * arrs.q_scale
        if metric == "l2":
            s = jnp.take(arrs.norms, safe, axis=0) - 2.0 * dots
        else:
            s = -dots
        return jnp.where(rows >= 0, s, INF)

    return score_rows


def cagra_search_impl(
    arrs: _SearchArrays,
    q: jax.Array,
    k: int,
    metric: str,
    ef: int,
    n_seeds: int,
    expand: int,
    max_iters: Optional[int],
    precision: str,
    packed: bool,
    fat: bool = False,
    dedupe: bool = True,
    seed_approx: bool = True,
    search_degree: Optional[int] = None,
):
    """Returns (user_scores [B, k], ids [B, k]); ids are row ids (== insertion
    order external ids — the graph never reorders rows)."""
    def body():
        qp = D.preprocess_queries(q, metric)
        efk = max(ef, k)
        # ---- seeds: one [B, A] matmul over the dense anchor table ----------
        cs = D.pairwise_scores(qp, arrs.anchors, arrs.a_norms, metric)
        s_count = min(n_seeds, arrs.anchors.shape[0])
        if seed_approx and arrs.anchors.shape[0] > 4 * s_count:
            seed_s, top = jax.lax.approx_min_k(cs, s_count)     # [B, S]
        else:
            neg, top = jax.lax.top_k(-cs, s_count)
            seed_s = -neg
        seeds = jnp.take(arrs.a_rows, top)                      # [B, S]
        # anchor scores ARE the seed scores (anchors store exact vectors);
        # avoids S extra row gathers per query
        if fat:
            deg = arrs.nbrs.shape[-1]
            expander = _make_fat_expander(arrs, qp, metric, deg)
            beam_s, beam_r = beam_layer_fn(
                None, seeds, seed_s, arrs.nbrs, efk,
                expand=expand, max_iters=max_iters, expand_fn=expander,
                dedupe_candidates=dedupe,
            )
        else:
            scorer = _make_scorer(arrs, qp, metric, packed)
            beam_s, beam_r = beam_layer_fn(
                scorer, seeds, seed_s, arrs.nbrs, efk,
                expand=expand, max_iters=max_iters,
                dedupe_candidates=dedupe, use_degree=search_degree,
            )
        beam_s, beam_r = T.mask_duplicate_ids(beam_s, beam_r)
        if arrs.dead is not None:
            # mark-and-filter delete: tombstoned rows were traversable all
            # the way here (they route), but never enter results
            hit = jnp.take(arrs.dead, jnp.maximum(beam_r, 0)) & (beam_r >= 0)
            beam_s = jnp.where(hit, INF, beam_s)
            beam_r = jnp.where(hit, -1, beam_r)
        top_s, top_r = T.smallest_k(beam_s, beam_r, k)
        valid = top_r >= 0
        user = D.finalize_scores(top_s, qp, metric)
        user = jnp.where(valid, user, INF if metric == "l2" else -INF)
        nonempty = arrs.n > 0
        ids = jnp.where(valid & nonempty, top_r, -1)
        return user, ids

    with D.precision_context(precision):
        return body()


cagra_search = jax.jit(
    cagra_search_impl,
    static_argnames=("k", "metric", "ef", "n_seeds", "expand", "max_iters",
                     "precision", "packed", "fat", "dedupe", "seed_approx",
                     "search_degree"),
)


# ---------------------------------------------------------------------------
# incremental extend (single-layer analog of build.py's batch step)


def _extend_batch_impl(state: CagraState, xb, valid, cfg: CagraConfig):
    """Append a batch at rows [n, n+B): beam-search the frozen prefix for
    candidates, diversity-prune to degree, connect + reverse-merge."""
    from .build import _reverse_pass, select_neighbors

    def body():
        b = xb.shape[0]
        base = state.n
        rows = base + jnp.arange(b, dtype=jnp.int32)
        if cfg.dtype == "int8":
            stored, norms = D.quantize_corpus_global(xb, cfg.metric, state.q_scale)
        else:
            stored, norms = D.preprocess_corpus(xb, cfg.metric, cfg.storage_dtype)
        vectors = jax.lax.dynamic_update_slice(state.vectors, stored, (base, 0))
        vnorms = jax.lax.dynamic_update_slice(state.norms, norms, (base,))
        st = state._replace(vectors=vectors, norms=vnorms)

        q = stored.astype(jnp.float32) * st.q_scale
        qn = D.sq_norms(q)
        store = VecStore(st.vectors, st.norms, st.q_scale)

        def score_rows(r):
            safe = jnp.maximum(r, 0)
            vx = jnp.take(st.vectors, safe, axis=0).astype(jnp.float32)
            dots = jnp.einsum("bd,bcd->bc", q, vx,
                              preferred_element_type=jnp.float32) * st.q_scale
            s = jnp.take(st.norms, safe, axis=0) - 2.0 * dots \
                if cfg.metric == "l2" else -dots
            return jnp.where(r >= 0, s, INF)

        # seeds from anchors (clamped to the frozen prefix)
        cs = D.pairwise_scores(q, st.anchors, st.a_norms, cfg.metric)
        s_count = min(cfg.n_seeds, st.anchors.shape[0])
        _, top = jax.lax.top_k(-cs, s_count)
        seeds = jnp.take(st.a_rows, top)
        seeds = jnp.where(seeds < base, seeds, -1)
        seed_s = score_rows(seeds)
        g_s, g_r = beam_layer_fn(
            score_rows, seeds, seed_s, st.nbrs, cfg.ef_construction,
            expand=cfg.expand, limit_n=base,
        )
        # intra-batch candidates (batchmates are invisible to the beam)
        intra = D.pairwise_scores(q, q, jnp.where(valid, qn, INF), cfg.metric)
        intra = jnp.where(jnp.eye(b, dtype=bool) | ~valid[None, :], INF, intra)
        i_s, i_c = T.smallest_k_dense(intra, min(b, cfg.ef_construction))
        i_rows = jnp.where(jnp.isfinite(i_s), base + i_c.astype(jnp.int32), -1)
        i_s = jnp.where(i_rows >= 0, i_s, INF)
        c_s = jnp.concatenate([g_s, i_s], axis=-1)
        c_r = jnp.concatenate([g_r, i_rows], axis=-1)
        c_s, c_r = T.mask_duplicate_ids(c_s, c_r)
        fwd, fwd_d = select_neighbors(
            store, q, qn, c_r, c_s, cfg.degree, cfg.alpha, cfg.metric,
        )
        fwd = jnp.where(valid[:, None], fwd, -1)
        fwd_d = jnp.where(fwd >= 0, fwd_d, INF)
        nbrs = jax.lax.dynamic_update_slice(st.nbrs, fwd, (base, 0))
        dists = jax.lax.dynamic_update_slice(st.dists, fwd_d, (base, 0))
        nbrs, dists = _reverse_pass(nbrs, dists, rows, fwd, fwd_d, cfg.degree)
        n = st.n + jnp.sum(valid).astype(jnp.int32)
        return st._replace(nbrs=nbrs, dists=dists, n=n)

    with D.precision_context(cfg.precision):
        return body()


_extend_batch = functools.partial(
    jax.jit, static_argnames=("cfg",), donate_argnums=(0,)
)(_extend_batch_impl)


# ---------------------------------------------------------------------------
# public class


class CagraIndex:
    """Single-layer graph index: build/insert/search/save/load/get."""

    def __init__(self, cfg: CagraConfig):
        self.cfg = cfg
        self.state: Optional[CagraState] = None
        self.capacity = 0
        self._key = jax.random.PRNGKey(cfg.seed)
        self._lock = threading.RLock()
        self._pending: list[np.ndarray] = []
        self._n_inserted = 0
        self._anchor_n = 0    # n at the last anchor snapshot (see _reseed_anchors)
        self._packed_table: Optional[jax.Array] = None  # derived, not saved
        self._fat_pack: Optional[jax.Array] = None      # derived, not saved
        self._dead: set[int] = set()                    # tombstoned ids
        self._dead_dev: Optional[jax.Array] = None      # [cap] bool mirror

    def __len__(self) -> int:
        with self._lock:
            n = 0 if self.state is None else int(self.state.n)
            return n + sum(p.shape[0] for p in self._pending) - len(self._dead)

    @property
    def dim(self) -> int:
        return self.cfg.dim

    # -- build --------------------------------------------------------------
    def build(self, x) -> None:
        """Bulk-build from corpus [N, D] (replaces contents).

        Accepts a host array (one upload) or a DEVICE-RESIDENT jax array
        (no transfer at all —
        serving/ingest pipelines that already hold the corpus on device
        build straight from it, the same convention as device-staged query
        batches)."""
        cfg = self.cfg
        on_device = isinstance(x, jax.Array)
        if not on_device:
            x = np.asarray(x, np.float32)
        n = x.shape[0]
        if n == 0:   # empty corpus -> empty index (reference: empty search
            # contract, src/test_hnsw.zig:43-53; also compact()-of-nothing)
            with self._lock:
                self._pending = []
                self._n_inserted = 0
                self.state = None
                self.capacity = 0
                self._packed_table = self._fat_pack = None
                self._dead = set()
                self._dead_dev = None
            return
        with self._lock:
            self._pending = []
            self._n_inserted = n
            if cfg.metric == "cosine" and n:
                if on_device:
                    x = x / jnp.maximum(
                        jnp.linalg.norm(x, axis=1, keepdims=True), 1e-12)
                else:
                    x = x / np.maximum(
                        np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
            self._key, sub, ksub = jax.random.split(self._key, 3)
            kw = dict(
                metric=cfg.metric, block=cfg.block,
                spill=cfg.spill, passes=cfg.passes,
                kmeans_iters=cfg.kmeans_iters, alpha=cfg.alpha,
                precision=cfg.precision, reps=cfg.seed_reps, n_long=cfg.n_long,
                kc_per_view=cfg.kc_per_view, prune_cap=cfg.prune_cap,
                block_topk=cfg.block_topk, kmeans_sample=cfg.kmeans_sample,
            )
            if not on_device and cfg.upload_segments > 1 \
                    and n >= _OVERLAP_MIN_N:
                # segmented upload: pass-0 k-means + per-segment assignment
                # execute on the landed prefix while later segments transfer
                # (see _OVERLAP_MIN_N)
                nseg = cfg.upload_segments
                per = -(-n // nseg)
                segs = [jax.device_put(x[i * per:(i + 1) * per])
                        for i in range(nseg) if i * per < n]
                nbrs, dists, _cent, _cn, _c_rows = build_knn_graph(
                    None, cfg.degree, sub, segments=segs, **kw)
                xj = jnp.concatenate(
                    [s.astype(jnp.float32) for s in segs], axis=0)
            else:
                xj = jnp.asarray(x, jnp.float32)   # ONE upload; device
                # arrays pass straight through
                nbrs, dists, _cent, _cn, _c_rows = build_knn_graph(
                    xj, cfg.degree, sub, **kw)
            q_scale = 1.0
            if cfg.dtype == "int8":
                amax = float(jnp.abs(xj).max()) if n else 1.0
                q_scale = max(amax, 1e-12) / 127.0
                stored, norms = D.quantize_corpus_global(
                    xj, cfg.metric, jnp.asarray(q_scale, jnp.float32)
                )
            else:
                stored, norms = D.preprocess_corpus(
                    xj, cfg.metric, cfg.storage_dtype
                )
            a_rows = _pick_anchor_rows(ksub, n, cfg.n_anchors)
            # anchors hold the DEQUANTIZED stored vectors so seed scores are
            # exactly what the beam scorer would compute for those rows
            anchors = jnp.take(stored, a_rows, axis=0).astype(jnp.float32) * q_scale
            a_norms = jnp.take(norms, a_rows) if cfg.metric == "l2" \
                else jnp.zeros((a_rows.shape[0],), jnp.float32)
            self.capacity = n
            self.state = CagraState(
                vectors=stored, norms=norms, nbrs=nbrs, dists=dists,
                anchors=anchors, a_norms=a_norms, a_rows=a_rows,
                n=jnp.asarray(n, jnp.int32),
                q_scale=jnp.asarray(q_scale, jnp.float32),
            )
            self._anchor_n = n
            self._packed_table = None
            self._fat_pack = None
            self._dead = set()
            self._dead_dev = None

    # -- delete ---------------------------------------------------------------
    def remove(self, ids) -> int:
        """Delete by external id (mark-and-filter; the reference has no
        delete at all — src/hnsw.zig:77's dense ids are safe only because
        nothing is removed). Ids never renumber and freed slots are not
        reused. Tombstoned nodes STAY in the graph as traversal waypoints
        (their edges keep routing beams) and are filtered from the final
        beam, so survivor recall does not collapse with delete fraction.
        Reclaim HBM/graph slots with compact(). Returns #newly deleted."""
        ids = np.unique(np.atleast_1d(np.asarray(ids, np.int64)))
        if ids.size == 0:
            return 0
        with self._lock:
            self._flush_locked()
            n = 0 if self.state is None else int(self.state.n)
            if (ids < 0).any() or (ids >= n).any():
                raise IndexError(f"ids must be in [0, {n})")
            new = [int(i) for i in ids if int(i) not in self._dead]
            if not new:
                return 0
            cap = self.state.vectors.shape[0]
            if self._dead_dev is None or self._dead_dev.shape[0] < cap:
                base = jnp.zeros((cap,), bool)
                if self._dead_dev is not None:
                    base = base.at[: self._dead_dev.shape[0]].set(
                        self._dead_dev)
                self._dead_dev = base
            self._dead_dev = self._dead_dev.at[
                jnp.asarray(np.asarray(new, np.int64))].set(True)
            self._dead.update(new)
            return len(new)

    def compact(self) -> np.ndarray:
        """Rebuild without the tombstoned rows; survivors renumber to
        [0, L) in former order. Returns the survivors' OLD ids (new_id ==
        position). Costs one bulk build — a batched accelerator build is
        this engine's answer to incremental graph repair (the usual HNSW
        delete-repair literature exists to avoid rebuilds that cost hours on
        CPUs)."""
        with self._lock:
            self._flush_locked()
            n = 0 if self.state is None else int(self.state.n)
            alive = np.ones(n, bool)
            if self._dead:
                alive[np.fromiter(self._dead, np.int64, len(self._dead))] = False
            live = np.flatnonzero(alive)
            if self.state is None:
                return live
            if live.size == n:
                return live
            vecs = jnp.take(
                self.state.vectors, jnp.asarray(live), axis=0
            ).astype(jnp.float32)
            if self.cfg.dtype == "int8":
                vecs = vecs * self.state.q_scale
        self.build(vecs)   # resets tombstones; takes the lock itself
        return live

    # -- incremental insert ---------------------------------------------------
    def insert(self, x) -> None:
        """Insert one vector [D] or a batch [B, D] (buffered; flushed on the
        next search — matches the HNSW engine's semantics)."""
        x = np.array(x, dtype=np.float32, copy=True)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[-1] != self.cfg.dim:
            raise ValueError(
                f"dimension mismatch: index dim {self.cfg.dim}, got {x.shape[-1]}"
            )
        with self._lock:
            self._pending.append(x)
            self._n_inserted += x.shape[0]
            if sum(p.shape[0] for p in self._pending) >= self.cfg.build_batch:
                self._flush_locked()

    add = insert

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._pending:
            return
        cfg = self.cfg
        new = np.concatenate(self._pending, axis=0)
        self._pending = []
        if self.state is None or int(self.state.n) == 0:
            n_before = self._n_inserted
            self.build(new)
            self._n_inserted = n_before
            return
        if cfg.metric == "cosine":
            new = new / np.maximum(np.linalg.norm(new, axis=1, keepdims=True), 1e-12)
        bsz = min(cfg.build_batch, max(new.shape[0], 1))
        nb = -(-new.shape[0] // bsz)
        need = int(self.state.n) + nb * bsz
        if need > self.capacity:
            self._grow(max(need, 2 * self.capacity))
        st = self.state
        for t in range(nb):
            lo, hi = t * bsz, min((t + 1) * bsz, new.shape[0])
            xb = np.zeros((bsz, cfg.dim), np.float32)
            xb[: hi - lo] = new[lo:hi]
            vb = np.zeros((bsz,), bool)
            vb[: hi - lo] = True
            st = _extend_batch(st, jnp.asarray(xb), jnp.asarray(vb), cfg)
        n_now = int(st.n)
        if n_now >= 2 * max(self._anchor_n, 1):
            self._key, ksub = jax.random.split(self._key)
            st = _reseed_anchors(st, n_now, ksub, cfg.n_anchors)
            self._anchor_n = n_now
        self.state = st
        self._packed_table = None
        self._fat_pack = None

    def _grow(self, new_cap: int) -> None:
        st = self.state
        cap = self.capacity
        d = self.cfg.dim
        deg = self.cfg.degree
        self.state = CagraState(
            vectors=jnp.zeros((new_cap, d), self.cfg.storage_dtype)
            .at[:cap].set(st.vectors),
            norms=jnp.zeros((new_cap,), jnp.float32).at[:cap].set(st.norms),
            nbrs=jnp.full((new_cap + 1, deg), -1, jnp.int32)
            .at[:cap].set(st.nbrs[:-1]),
            dists=jnp.full((new_cap + 1, deg), jnp.inf, jnp.float32)
            .at[:cap].set(st.dists[:-1]),
            anchors=st.anchors, a_norms=st.a_norms, a_rows=st.a_rows,
            n=st.n, q_scale=st.q_scale,
        )
        self.capacity = new_cap

    # -- search ---------------------------------------------------------------
    def _fat_enabled(self) -> bool:
        cfg = self.cfg
        if cfg.fat_rows == "off" or self.state is None:
            return False
        cap = self.state.nbrs.shape[0]
        if cap - 1 >= (1 << 24):     # f32-exact id range
            return False
        if cfg.fat_rows == "on":
            return True
        bytes_needed = cap * cfg.degree * (cfg.dim + 2) * 4
        return cfg.dtype == "float32" and bytes_needed <= cfg.fat_budget_bytes

    def _search_arrays(self) -> _SearchArrays:
        st = self.state
        if self._fat_enabled():
            if self._fat_pack is None:
                self._fat_pack = _build_fat_pack(
                    st.vectors, st.norms, st.nbrs, st.q_scale)
            table = self._fat_pack
        elif self.cfg.packed:
            if self._packed_table is None:
                self._packed_table = jnp.concatenate(
                    [st.vectors, st.norms[:, None]], axis=1
                )
            table = self._packed_table
        else:
            table = st.vectors
        dead = None
        if self._dead:
            dead = self._dead_dev
            cap = st.vectors.shape[0]
            if dead.shape[0] < cap:   # capacity grew since the last remove
                dead = jnp.zeros((cap,), bool).at[: dead.shape[0]].set(dead)
                self._dead_dev = dead
        return _SearchArrays(
            table=table, norms=st.norms, nbrs=st.nbrs, anchors=st.anchors,
            a_norms=st.a_norms, a_rows=st.a_rows, n=st.n, q_scale=st.q_scale,
            dead=dead,
        )

    def search(self, q, k: int, ef_search: Optional[int] = None,
               search_degree: Optional[int] = None,
               max_iters: Optional[int] = None, allowed=None,
               filter_mode: str = "auto"):
        """kNN search. q [D] or [B, D] -> (scores, ids) [B, k] ([k] squeezed).
        Invalid slots: id -1 (reference returns < k results when n < k).
        ef_search / search_degree / max_iters override the config per call
        (search-time-only knobs — the graph is unchanged; each distinct
        combination is its own compiled program).
        allowed: optional allowlist (bool mask over ids, or int id array).
        filter_mode governs how it executes:
          "auto" (default) — "scan" unless the corpus is past the measured
            crossover AND the filter is near-all-pass, where the beam keeps
            its recall and is sublinear (utils/filter_policy.py).
          "scan" — EXACT masked brute-force scan over the stored
            rows (flat.masked_exact_search). Measured round 4: the beam
            path collapses on selective filters (0.358 recall @ 83 QPS at
            1% selectivity even at ef=1200) while the masked scan is exact
            and FASTER at every selectivity tried (1%-50%, 100k-1M).
          "beam" — the graph beam with non-matching nodes routing but
            filtered from the final ef-wide beam; raise ef_search for
            selective filters. Only competitive when the filter is nearly
            all-pass."""
        if filter_mode not in ("auto", "scan", "beam"):
            raise ValueError(f"invalid filter_mode {filter_mode!r}")
        with self._lock:
            self._flush_locked()
            if filter_mode == "auto":
                from ..utils.filter_policy import resolve_filter_mode

                filter_mode = resolve_filter_mode(
                    "auto", allowed, self._n_inserted, alt="beam")
            q = jnp.asarray(q, jnp.float32)
            squeeze = q.ndim == 1
            if squeeze:
                q = q[None, :]
            if q.shape[-1] != self.cfg.dim:
                raise ValueError(
                    f"dimension mismatch: index dim {self.cfg.dim}, got {q.shape[-1]}"
                )
            cfg = self.cfg
            if self.state is None or int(self.state.n) == 0:
                s = jnp.full((q.shape[0], k), INF if cfg.metric == "l2" else -INF)
                i = jnp.full((q.shape[0], k), -1, jnp.int32)
            elif allowed is not None and filter_mode == "scan":
                from ..utils.masks import allowed_mask
                from .flat import masked_exact_search

                st = self.state
                cap = st.vectors.shape[0]
                block = ~allowed_mask(allowed, int(st.n), cap)
                arrs = self._search_arrays()
                if arrs.dead is not None:
                    block = block | arrs.dead
                bias = jnp.where(block, INF, 0.0)
                s, i = masked_exact_search(
                    st.vectors, st.norms + bias,
                    jnp.broadcast_to(st.q_scale, (cap,)), q, k, cfg.metric,
                    precision=("high" if cfg.precision == "default"
                               else cfg.precision))
            else:
                arrs = self._search_arrays()
                if allowed is not None:
                    from ..utils.masks import allowed_mask

                    cap = self.state.vectors.shape[0]
                    block = ~allowed_mask(allowed, int(self.state.n), cap)
                    arrs = arrs._replace(
                        dead=block if arrs.dead is None
                        else (arrs.dead | block))
                s, i = cagra_search(
                    arrs, q, k, cfg.metric,
                    ef_search if ef_search is not None else cfg.ef_search,
                    cfg.n_seeds, cfg.expand,
                    max_iters if max_iters is not None else cfg.max_iters,
                    cfg.precision,
                    cfg.packed, self._fat_enabled(), True, cfg.seed_approx,
                    search_degree if search_degree is not None
                    else cfg.search_degree,
                )
            if squeeze:
                return s[0], i[0]
            return s, i

    # -- parity/convenience -----------------------------------------------
    def get(self, ids) -> np.ndarray:
        """Stored vectors for ids (row order = insertion order) -> [K, D] f32
        (reference parity: search results carry the stored point,
        src/hnsw.zig:235). Dequantized for int8; normalized for cosine."""
        with self._lock:
            self._flush_locked()
            ids = np.atleast_1d(np.asarray(ids, np.int64))
            n = 0 if self.state is None else int(self.state.n)
            if ids.size == 0:
                return np.zeros((0, self.cfg.dim), np.float32)
            if (ids < 0).any() or (ids >= n).any():
                raise IndexError(f"ids must be in [0, {n})")
            if self._dead and any(int(i) in self._dead for i in ids):
                raise IndexError("id was deleted")
            vecs = np.asarray(
                jnp.take(self.state.vectors, jnp.asarray(ids), axis=0)
                .astype(jnp.float32)
            )
            if self.cfg.dtype == "int8":
                vecs = vecs * float(self.state.q_scale)
            return vecs

    # -- persistence --------------------------------------------------------
    def save(self, path: str) -> None:
        import json

        with self._lock:
            self._flush_locked()
            meta = dict(cfg=dataclasses.asdict(self.cfg),
                        capacity=self.capacity, n_inserted=self._n_inserted)
            arrays = {}
            if self.state is not None:
                for f in CagraState._fields:
                    v = np.asarray(getattr(self.state, f))
                    if str(v.dtype) == "bfloat16":
                        v = v.astype(np.float32)
                    arrays[f] = v
            if self._dead:
                arrays["dead_rows"] = np.asarray(sorted(self._dead), np.int64)
            np.savez_compressed(path, meta=json.dumps(meta), **arrays)

    @classmethod
    def load(cls, path: str) -> "CagraIndex":
        import json

        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            cfg = CagraConfig(**meta["cfg"])
            idx = cls(cfg)
            idx.capacity = meta["capacity"]
            idx._n_inserted = meta["n_inserted"]
            if "vectors" in z:
                idx.state = CagraState(
                    vectors=jnp.asarray(z["vectors"], cfg.storage_dtype),
                    norms=jnp.asarray(z["norms"]),
                    nbrs=jnp.asarray(z["nbrs"]),
                    dists=jnp.asarray(z["dists"]),
                    anchors=jnp.asarray(z["anchors"]),
                    a_norms=jnp.asarray(z["a_norms"]),
                    a_rows=jnp.asarray(z["a_rows"]),
                    n=jnp.asarray(z["n"]),
                    q_scale=jnp.asarray(z["q_scale"]),
                )
                idx._anchor_n = int(z["n"])
                if "dead_rows" in z:
                    dead = np.asarray(z["dead_rows"], np.int64)
                    idx._dead = set(int(i) for i in dead)
                    cap = idx.state.vectors.shape[0]
                    idx._dead_dev = (
                        jnp.zeros((cap,), bool).at[jnp.asarray(dead)].set(True))
        return idx
