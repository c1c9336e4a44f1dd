"""Flat (brute-force) index — exact kNN as dense matmuls.

Serves three roles (SURVEY.md §7 M0):
  1. recall ground-truth oracle for the graph engine,
  2. the distance kernel the graph engine reuses,
  3. a fast exact path for small corpora.

The corpus axis is tiled so [B, N] score matrices never exceed memory; tiles are
scanned with a running top-k merge (`lax.scan`), keeping everything static-shaped
for XLA.
"""
from __future__ import annotations

import functools
import json
import threading
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import distance as D
from ..ops import topk as T
from ..ops.flat_scan import flat_scan_topk, interpret_mode
from ..utils.config import FlatConfig, config_from_dict


class FlatState(NamedTuple):
    """Device-resident flat index state (a pytree)."""

    vectors: jax.Array   # [cap, D] storage dtype (f32/bf16/int8 codes)
    norms: jax.Array     # [cap] f32 squared norms (zeros unless metric == l2)
    scales: jax.Array    # [cap] f32 dequant scales (1.0 for float dtypes)
    n: jax.Array         # scalar int32 live count


def init_state(capacity: int, cfg: FlatConfig) -> FlatState:
    # norms double as the validity bias: +inf until a row is ingested (all
    # metrics), so search never materializes a [B, N] mask
    return FlatState(
        vectors=jnp.zeros((capacity, cfg.dim), cfg.storage_dtype),
        norms=jnp.full((capacity,), jnp.inf, jnp.float32),
        scales=jnp.ones((capacity,), jnp.float32),
        n=jnp.zeros((), jnp.int32),
    )


@functools.partial(jax.jit, static_argnames=("metric", "dtype_name"))
def _ingest(state: FlatState, x: jax.Array, metric: str, dtype_name: str) -> FlatState:
    if dtype_name == "int8":
        stored, scales, norms = D.quantize_corpus(x, metric)
    else:
        dtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype_name]
        stored, norms = D.preprocess_corpus(x, metric, dtype)
        scales = jnp.ones(x.shape[:-1], jnp.float32)
    b = x.shape[0]
    vecs = jax.lax.dynamic_update_slice(state.vectors, stored, (state.n, 0))
    ns = jax.lax.dynamic_update_slice(state.norms, norms, (state.n,))
    sc = jax.lax.dynamic_update_slice(state.scales, scales, (state.n,))
    return FlatState(vecs, ns, sc, state.n + b)


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "tile_n", "approx", "recall_target", "precision"),
)
def _search(
    state: FlatState, q: jax.Array, k: int, metric: str, tile_n: int,
    approx: bool = False, recall_target: float = 0.95, precision: str = "highest",
):
    """Top-k: scan corpus tiles, merge running top-k. Returns (scores, ids).

    approx=True uses the partial-reduce top-k lax.approx_min_k (PAPERS.md,
    "K Nearest Neighbor Search at Peak FLOP/s") with exact matmul scoring: per-query
    selection recall >= recall_target.

    Scores are user-facing (squared L2 distance, or similarity for dot/cosine
    as ranked ascending-surrogate then finalized).
    """
    cap = state.vectors.shape[0]
    tile = min(tile_n, cap)
    n_tiles = -(-cap // tile)
    pad_cap = n_tiles * tile

    qs = D.preprocess_queries(q, metric)
    b = qs.shape[0]

    vec_t = jnp.pad(state.vectors, ((0, pad_cap - cap), (0, 0))).reshape(
        n_tiles, tile, -1
    )
    norm_t = jnp.pad(state.norms, (0, pad_cap - cap), constant_values=jnp.inf).reshape(
        n_tiles, tile
    )
    scale_t = jnp.pad(state.scales, (0, pad_cap - cap), constant_values=1.0).reshape(
        n_tiles, tile
    )

    init = (
        jnp.full((b, k), jnp.inf, jnp.float32),
        jnp.full((b, k), -1, jnp.int32),
    )

    def body(carry, inputs):
        t_idx, vecs, norms, scales = inputs
        best_s, best_i = carry
        prec = D.matmul_precision(precision)
        # un-ingested/padding rows carry norms=+inf, so scores are +inf there —
        # no [B, tile] id/mask arrays are ever materialized (at 1M x 10k they
        # would be tens of GB and dominate the scan's runtime)
        s = D.pairwise_scores(qs, vecs, norms, metric, precision=prec,
                              x_scales=scales)  # [B, tile]
        kk = min(k, tile)
        if approx:
            ts, tp = jax.lax.approx_min_k(s, kk, recall_target=recall_target)
        else:
            neg, tp = jax.lax.top_k(-s, kk)
            ts = -neg
        ti = t_idx * tile + tp.astype(jnp.int32)
        ti = jnp.where(jnp.isfinite(ts), ti, -1)
        ts = jnp.where(ti >= 0, ts, jnp.inf)
        if kk < k:
            ts = jnp.pad(ts, ((0, 0), (0, k - kk)), constant_values=jnp.inf)
            ti = jnp.pad(ti, ((0, 0), (0, k - kk)), constant_values=-1)
        return T.merge_topk(best_s, best_i, ts, ti, k), None

    (best_s, best_i), _ = jax.lax.scan(
        body, init, (jnp.arange(n_tiles, dtype=jnp.int32), vec_t, norm_t, scale_t)
    )
    out = D.finalize_scores(best_s, qs, metric)
    out = jnp.where(best_i >= 0, out, jnp.inf if metric == "l2" else -jnp.inf)
    return out, best_i


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "tile_n", "recall_target",
                     "scan_precision", "rerank"),
)
def _search_rerank(
    state: FlatState, q: jax.Array, k: int, metric: str, tile_n: int,
    recall_target: float = 0.95, scan_precision: str = "default",
    rerank: int = 4,
):
    """Two-pass approx search: native-rate scan + exact rerank.

    Pass 1 runs the tiled approx scan at `scan_precision` ("default" = the
    platform's fastest matmul; bf16's ~4e-3 relative error would crater
    top-k recall directly) keeping rerank*k candidates. Pass 2 gathers
    those rows (B * rerank*k gathers) and rescores at full f32, repairing
    the ranking. Returns user-facing (scores, ids).
    """
    kk = max(k * rerank, k)
    qs = D.preprocess_queries(q, metric)
    s1, i1 = _search(state, q, kk, metric, tile_n, approx=True,
                     recall_target=recall_target, precision=scan_precision)
    safe = jnp.maximum(i1, 0)
    rv = jnp.take(state.vectors, safe, axis=0).astype(jnp.float32)
    rv = rv * jnp.take(state.scales, safe, axis=0)[..., None]
    rn = jnp.take(state.norms, safe, axis=0)
    dots = jnp.einsum("bd,bcd->bc", qs, rv,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
    ex = rn - 2.0 * dots if metric == "l2" else rn - dots
    ex = jnp.where(i1 >= 0, ex, jnp.inf)
    best_s, best_i = T.smallest_k(ex, i1, k)
    out = D.finalize_scores(best_s, qs, metric)
    out = jnp.where(best_i >= 0, out, jnp.inf if metric == "l2" else -jnp.inf)
    return out, best_i


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "l_bins", "seg_rows", "bq", "precision",
                     "rerank", "interpret"),
)
def _search_fused(
    state: FlatState, q: jax.Array, k: int, metric: str, l_bins: int,
    seg_rows: int, bq: int, precision: str, rerank: int, interpret: bool,
):
    """Fused-kernel path (ops/flat_scan.py): the scan scores and bin-folds
    on chip at `precision`; with rerank > 0 it keeps rerank*k bin winners
    and rescores them in f32 against the stored rows (the same two-pass
    structure as `_search_rerank`). Returns user-facing (scores, ids)."""
    qs = D.preprocess_queries(q, metric)
    kk = max(k * rerank, k)
    s1, i1 = flat_scan_topk(
        qs, state.vectors, state.norms, kk, l_bins=l_bins, seg_rows=seg_rows,
        bq=bq, metric=metric, precision=precision, interpret=interpret)
    if rerank:
        safe = jnp.maximum(i1, 0)
        rv = jnp.take(state.vectors, safe, axis=0).astype(jnp.float32)
        rn = jnp.take(state.norms, safe, axis=0)
        dots = jnp.einsum("bd,bcd->bc", qs, rv,
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
        ex = rn - 2.0 * dots if metric == "l2" else rn - dots
        ex = jnp.where(i1 >= 0, ex, jnp.inf)
        s1, i1 = T.smallest_k(ex, i1, k)
    out = D.finalize_scores(s1, qs, metric)
    out = jnp.where(i1 >= 0, out, jnp.inf if metric == "l2" else -jnp.inf)
    return out, i1


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "tile_n", "recall_target", "rerank"),
)
def _search_pca_rerank(
    proj: FlatState, state: FlatState, basis: jax.Array, mean: jax.Array,
    q: jax.Array, k: int, metric: str, tile_n: int, recall_target: float,
    rerank: int,
):
    """PCA-filtered two-pass search (pHNSW/AQR pattern, PAPERS.md): pass 1
    scans the PROJECTED corpus (D -> p cuts the dominant matmul by D/p),
    pass 2 rescores the rerank*k survivors exactly in full dimension.
    Candidate ranking in the subspace is approximate; the exact rerank
    repairs it (same structure as _search_rerank)."""
    kk = max(k * rerank, k)
    qs = D.preprocess_queries(q, metric)   # cosine: normalize BEFORE project
    qp = (qs - mean[None, :]) @ basis      # [B, p]
    s1, i1 = _search(proj, qp, kk, metric, tile_n, approx=True,
                     recall_target=recall_target, precision="default")
    safe = jnp.maximum(i1, 0)
    rv = jnp.take(state.vectors, safe, axis=0).astype(jnp.float32)
    rv = rv * jnp.take(state.scales, safe, axis=0)[..., None]
    rn = jnp.take(state.norms, safe, axis=0)
    dots = jnp.einsum("bd,bcd->bc", qs, rv,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
    ex = rn - 2.0 * dots if metric == "l2" else rn - dots
    ex = jnp.where(i1 >= 0, ex, jnp.inf)
    best_s, best_i = T.smallest_k(ex, i1, k)
    out = D.finalize_scores(best_s, qs, metric)
    out = jnp.where(best_i >= 0, out, jnp.inf if metric == "l2" else -jnp.inf)
    return out, best_i


@functools.partial(jax.jit, static_argnames=("metric",))
def _project_corpus(state: FlatState, basis: jax.Array, mean: jax.Array,
                    metric: str) -> FlatState:
    """Projected shadow of the corpus for the PCA first pass. Norm channel
    keeps the validity convention: +inf rows (uningested/tombstoned) stay
    +inf so the projected scan masks exactly what the full scan would."""
    vecs = state.vectors.astype(jnp.float32) * state.scales[:, None]
    pv = (vecs - mean[None, :]) @ basis                   # [cap, p]
    if metric == "l2":
        pn = D.sq_norms(pv)
    else:
        pn = jnp.zeros((pv.shape[0],), jnp.float32)
    pn = jnp.where(jnp.isinf(state.norms), jnp.inf, pn)
    return FlatState(vectors=pv, norms=pn,
                     scales=jnp.ones((pv.shape[0],), jnp.float32),
                     n=state.n)


@functools.partial(jax.jit, static_argnames=("metric", "tile_n",
                                              "precision"))
def _count_range(state: FlatState, q: jax.Array, radius: jax.Array,
                 metric: str, tile_n: int, precision: str):
    """Exact in-range neighbor count per query [B] (user-score convention:
    squared-L2 <= radius for l2, similarity >= radius for dot/cosine).
    Same tiled scan shape as _search; invalid/tombstoned rows carry +inf
    surrogate and never count."""
    cap = state.vectors.shape[0]
    tile = min(tile_n, cap)
    n_tiles = -(-cap // tile)
    pad_cap = n_tiles * tile
    qs = D.preprocess_queries(q, metric)
    # surrogate-space threshold: l2 user = surrogate + ||q||^2;
    # dot/cos user = -surrogate
    thr = (radius - D.sq_norms(qs)) if metric == "l2" \
        else jnp.full((qs.shape[0],), -radius, jnp.float32)
    vec_t = jnp.pad(state.vectors, ((0, pad_cap - cap), (0, 0))).reshape(
        n_tiles, tile, -1)
    norm_t = jnp.pad(state.norms, (0, pad_cap - cap),
                     constant_values=jnp.inf).reshape(n_tiles, tile)
    scale_t = jnp.pad(state.scales, (0, pad_cap - cap),
                      constant_values=1.0).reshape(n_tiles, tile)
    prec = D.matmul_precision(precision)

    def body(acc, inputs):
        vecs, norms, scales = inputs
        s = D.pairwise_scores(qs, vecs, norms, metric, precision=prec,
                              x_scales=scales)
        return acc + (s <= thr[:, None]).sum(axis=1, dtype=jnp.int32), None

    acc0 = jnp.zeros((qs.shape[0],), jnp.int32)
    counts, _ = jax.lax.scan(body, acc0, (vec_t, norm_t, scale_t))
    return counts


class FlatIndex:
    """Exact kNN index. API mirrors the reference HNSW surface
    (init/insert/search — reference src/hnsw.zig:52,73,194) with batching."""

    def __init__(self, cfg: FlatConfig, capacity: int = 0):
        self.cfg = cfg
        self.capacity = int(capacity)
        self.state: Optional[FlatState] = (
            init_state(self.capacity, cfg) if capacity else None
        )
        self._dead: set[int] = set()   # tombstoned external ids (host mirror)
        # Guards mutations (add/remove/compact/build): each is a
        # read-modify-write of self.state, so two concurrent mutators could
        # drop one's update. Searches stay lock-free — they read self.state
        # once (an atomic attribute read of an immutable pytree snapshot);
        # the reference serialized reads too (src/hnsw.zig:195), which is
        # exactly the contention its own benchmark notes blame.
        self._write_lock = threading.RLock()
        # PCA-filter derived state (cfg.pca_dim > 0): projected corpus +
        # basis, rebuilt lazily when contents change — never persisted
        self._proj: Optional[FlatState] = None
        self._proj_basis: Optional[jax.Array] = None   # [D, p]
        self._proj_mean: Optional[jax.Array] = None    # [D] (zeros for dot)
        self._proj_rev = None   # mutation counter the projection reflects
        self._mutations = 0      # bumped on every content change

    def __len__(self) -> int:
        """Live count (inserted minus deleted)."""
        return (0 if self.state is None else int(self.state.n)) - len(self._dead)

    @property
    def dim(self) -> int:
        return self.cfg.dim

    @property
    def _n_total(self) -> int:
        """Slots used, including tombstones (== the next insert id)."""
        return 0 if self.state is None else int(self.state.n)

    def _ensure_capacity(self, extra: int):
        need = self._n_total + extra
        if self.state is None:
            self.capacity = max(need, 1024)
            self.state = init_state(self.capacity, self.cfg)
        elif need > self.capacity:
            new_cap = max(need, 2 * self.capacity)
            old = self.state
            grown = init_state(new_cap, self.cfg)
            self.state = FlatState(
                vectors=grown.vectors.at[: self.capacity].set(old.vectors),
                norms=grown.norms.at[: self.capacity].set(old.norms),
                scales=grown.scales.at[: self.capacity].set(old.scales),
                n=old.n,
            )
            self.capacity = new_cap

    def add(self, x) -> None:
        """Insert a batch [B, D] (or a single vector [D])."""
        x = jnp.asarray(x)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[-1] != self.cfg.dim:
            raise ValueError(
                f"dimension mismatch: index dim {self.cfg.dim}, got {x.shape[-1]}"
            )
        with self._write_lock:
            self._ensure_capacity(x.shape[0])
            self.state = _ingest(self.state, x, self.cfg.metric, self.cfg.dtype)
            self._mutations += 1

    insert = add  # reference-parity alias (src/hnsw.zig:73)

    def build(self, x) -> None:
        """Replace contents with corpus x (engine-uniform bulk-build API)."""
        with self._write_lock:
            self.state = None
            self.capacity = 0
            self._dead = set()
            self.add(x)

    def remove(self, ids) -> int:
        """Delete by external id (tombstone). Ids never renumber — the
        reference's dense sequential ids (src/hnsw.zig:77) stay stable, and
        freed slots are NOT reused. On-device this is one scatter setting the
        rows' norm bias to +inf, which every search path (XLA scan, rerank,
        Pallas kernel) already treats as "invalid row" for all metrics —
        deleted rows can never appear in results. HBM is reclaimed by
        compact(). Returns the number of rows newly deleted."""
        ids = np.unique(np.atleast_1d(np.asarray(ids, np.int64)))
        if ids.size == 0:
            return 0
        with self._write_lock:
            n = self._n_total
            if (ids < 0).any() or (ids >= n).any():
                raise IndexError(f"ids must be in [0, {n})")
            new = [int(i) for i in ids if int(i) not in self._dead]
            if not new:
                return 0
            rows = jnp.asarray(np.asarray(new, np.int64))
            self.state = self.state._replace(
                norms=self.state.norms.at[rows].set(jnp.inf))
            self._dead.update(new)
            self._mutations += 1
            return len(new)

    def compact(self) -> np.ndarray:
        """Drop tombstoned rows and renumber the survivors to [0, L) in their
        former order. Returns the survivors' OLD ids ([L] int64), so
        new_id == position in the returned array. No re-quantization: stored
        codes/norms/scales move verbatim."""
        with self._write_lock:
            n = self._n_total
            live = np.ones(n, bool)
            if self._dead:
                live[np.fromiter(self._dead, np.int64, len(self._dead))] = False
            live_np = np.flatnonzero(live)
            if self.state is not None and live_np.size < n:
                if live_np.size == 0:   # everything deleted -> empty index
                    self.state = None
                    self.capacity = 0
                else:
                    rows = jnp.asarray(live_np)
                    self.state = FlatState(
                        vectors=jnp.take(self.state.vectors, rows, axis=0),
                        norms=jnp.take(self.state.norms, rows, axis=0),
                        scales=jnp.take(self.state.scales, rows, axis=0),
                        n=jnp.asarray(live_np.size, jnp.int32),
                    )
                    self.capacity = int(live_np.size)
            self._dead = set()
            self._mutations += 1
            return live_np

    def save(self, path: str) -> None:
        """npz snapshot (config + arrays). Tombstones ride in `norms` (+inf
        rows), so deletes round-trip with no extra field."""
        import dataclasses

        if self.state is None:
            raise ValueError("empty index")
        np.savez(
            path,
            cfg=json.dumps(dataclasses.asdict(self.cfg)),
            capacity=np.int64(self.capacity),
            vectors=np.asarray(self.state.vectors),
            norms=np.asarray(self.state.norms),
            scales=np.asarray(self.state.scales),
            n=np.asarray(self.state.n),
        )

    @classmethod
    def load(cls, path: str) -> "FlatIndex":
        z = np.load(path, allow_pickle=False)
        cfg = config_from_dict(FlatConfig, json.loads(str(z["cfg"])))
        idx = cls(cfg)
        idx.capacity = int(z["capacity"])
        idx.state = FlatState(
            vectors=jnp.asarray(z["vectors"]),
            norms=jnp.asarray(z["norms"]),
            scales=jnp.asarray(z["scales"]),
            n=jnp.asarray(z["n"]),
        )
        n = int(idx.state.n)
        dead = np.flatnonzero(np.isinf(np.asarray(z["norms"])[:n]))
        idx._dead = set(int(i) for i in dead)
        return idx

    def get(self, ids) -> np.ndarray:
        """Stored vectors for external ids (row order = insertion order) ->
        [K, D] f32. Reference parity: search results carry the stored point
        (src/hnsw.zig:235); dequantized for int8, normalized for cosine."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        n = self._n_total
        if ids.size == 0:
            return np.zeros((0, self.cfg.dim), np.float32)
        if (ids < 0).any() or (ids >= n).any():
            raise IndexError(f"ids must be in [0, {n})")
        if self._dead and any(int(i) in self._dead for i in ids):
            raise IndexError("id was deleted")
        rows = jnp.asarray(ids)
        vecs = np.asarray(
            jnp.take(self.state.vectors, rows, axis=0).astype(jnp.float32)
        )
        if self.cfg.dtype == "int8":
            vecs = vecs * np.asarray(jnp.take(self.state.scales, rows))[:, None]
        return vecs

    def _ensure_projection(self) -> None:
        """(Re)build the PCA basis + projected corpus when contents changed.
        Basis: top pca_dim right singular vectors of a corpus sample
        (centered for l2 — pairwise differences are centering-invariant;
        UNcentered for dot/cosine, where centering would corrupt dots)."""
        rev = self._mutations
        if self._proj is not None and self._proj_rev == rev:
            return
        cfg = self.cfg
        n = self._n_total
        p = min(cfg.pca_dim, cfg.dim)
        sample_rows = np.linspace(
            0, max(n - 1, 0), num=min(n, 16384), dtype=np.int64)
        sample = np.asarray(
            jnp.take(self.state.vectors, jnp.asarray(sample_rows), axis=0)
            .astype(jnp.float32)
            * jnp.take(self.state.scales, jnp.asarray(sample_rows))[:, None])
        mean = sample.mean(0) if cfg.metric == "l2" \
            else np.zeros(cfg.dim, np.float32)
        _, _, vt = np.linalg.svd(sample - mean, full_matrices=False)
        self._proj_basis = jnp.asarray(vt[:p].T.astype(np.float32))  # [D, p]
        self._proj_mean = jnp.asarray(mean.astype(np.float32))
        self._proj = _project_corpus(
            self.state, self._proj_basis, self._proj_mean, cfg.metric)
        self._proj_rev = rev

    def search(self, q, k: int, approx: bool = False, allowed=None):
        """Top-k. q: [B, D] or [D]. Returns (scores [B,k], ids [B,k]).

        approx=False: exact (full sort). approx=True: partial-reduce top-k
        with per-query selection recall >= cfg.recall_target (scoring is
        still a dense matmul either way), or the fused kernel when
        cfg.scan == "pallas".

        allowed: optional allowlist (bool mask over external ids, or an int
        id array) — filtered search; only listed ids can appear in results.
        Exact on this engine for every selectivity (the scan scores all rows
        and the filter is one validity-bias mask; no candidate-pool loss).

        Empty index -> all ids are -1 (reference: empty result, src/hnsw.zig:201).
        k > n -> trailing slots have id -1 (reference returns n results,
        src/test_hnsw.zig:104-126).
        """
        q = jnp.asarray(q)
        squeeze = q.ndim == 1
        if squeeze:
            q = q[None, :]
        if q.shape[-1] != self.cfg.dim:
            raise ValueError(
                f"dimension mismatch: index dim {self.cfg.dim}, got {q.shape[-1]}"
            )
        state = self.state
        proj = None
        if state is not None and allowed is not None:
            from ..utils.masks import allowed_mask

            mask = allowed_mask(allowed, self._n_total,
                                state.vectors.shape[0])
            state = state._replace(
                norms=jnp.where(mask, state.norms, jnp.inf))
            if approx and self.cfg.pca_dim > 0:
                self._ensure_projection()
                proj = self._proj._replace(
                    norms=jnp.where(mask, self._proj.norms, jnp.inf))
        if state is None:
            s = jnp.full((q.shape[0], k), jnp.inf, jnp.float32)
            i = jnp.full((q.shape[0], k), -1, jnp.int32)
        elif approx and self.cfg.pca_dim > 0:
            if proj is None:
                self._ensure_projection()
                proj = self._proj
            s, i = _search_pca_rerank(
                proj, state, self._proj_basis, self._proj_mean,
                q, k, self.cfg.metric, self.cfg.tile_n,
                self.cfg.recall_target, max(self.cfg.rerank, 4),
            )
        elif approx and self.cfg.scan == "pallas" and self.cfg.dtype != "int8" \
                and allowed is None:
            # fused scan (+ rerank); filtered search takes the XLA path
            cfg = self.cfg
            s, i = _search_fused(
                state, q, k, cfg.metric, cfg.l_bins, cfg.pallas_chunk,
                cfg.pallas_bq,
                cfg.scan_precision if cfg.rerank else cfg.precision,
                cfg.rerank, interpret_mode())
        elif approx and self.cfg.rerank:
            s, i = _search_rerank(
                state, q, k, self.cfg.metric, self.cfg.tile_n,
                recall_target=self.cfg.recall_target,
                scan_precision=self.cfg.scan_precision,
                rerank=self.cfg.rerank,
            )
        else:
            s, i = _search(
                state, q, k, self.cfg.metric, self.cfg.tile_n,
                approx=approx, recall_target=self.cfg.recall_target,
                precision=self.cfg.precision,
            )
        if squeeze:
            return s[0], i[0]
        return s, i

    def search_range(self, q, radius: float, max_results: int = 128):
        """All neighbors within `radius`: squared-L2 <= radius for l2, or
        similarity >= radius for dot/cosine (user-facing score convention,
        matching search()). Fixed-capacity form of the classic
        range query: returns (scores [B, R], ids [B, R], counts [B]) with
        R = max_results. counts is the EXACT number of in-range neighbors;
        when counts[b] > R the row holds the R best (re-query with a larger
        max_results for the full set). Invalid slots: id -1. Exact scoring
        (cfg.precision), one extra counting pass over the corpus tiles."""
        q = jnp.asarray(q)
        squeeze = q.ndim == 1
        if squeeze:
            q = q[None, :]
        if q.shape[-1] != self.cfg.dim:
            raise ValueError(
                f"dimension mismatch: index dim {self.cfg.dim}, got {q.shape[-1]}"
            )
        if self.state is None:
            s = jnp.full((q.shape[0], max_results), jnp.inf, jnp.float32)
            i = jnp.full((q.shape[0], max_results), -1, jnp.int32)
            c = jnp.zeros((q.shape[0],), jnp.int32)
        else:
            s, i = _search(
                self.state, q, max_results, self.cfg.metric, self.cfg.tile_n,
                approx=False, precision=self.cfg.precision,
            )
            if self.cfg.metric == "l2":
                in_r = (s <= radius) & (i >= 0)
            else:
                in_r = (s >= radius) & (i >= 0)
            i = jnp.where(in_r, i, -1)
            s = jnp.where(in_r, s, jnp.inf if self.cfg.metric == "l2"
                          else -jnp.inf)
            # radius is TRACED (one compiled program serves every radius;
            # each distinct value would otherwise cost a compile)
            c = _count_range(
                self.state, q, jnp.asarray(radius, jnp.float32),
                self.cfg.metric, self.cfg.tile_n, self.cfg.precision,
            )
        if squeeze:
            return s[0], i[0], c[0]
        return s, i, c


def masked_exact_search(vectors, norms_bias, scales, q, k: int, metric: str,
                        tile_n: int = 131072, precision: str = "high",
                        approx: bool = True, recall_target: float = 0.97):
    """Exact-scoring top-k over an arbitrary (vectors, norms+validity-bias,
    scales) view — the shared masked-scan fallback the graph/IVF engines
    route FILTERED search through. norms_bias carries +inf for every
    blocked/dead/padding row (the all-metric validity-bias convention).

    Beam-filtered graph search collapses at selective filters (the beam
    runs out of allowed neighbours), while this masked scan is EXACT at
    every selectivity. Its speed on the H100 is not yet measured."""
    st = FlatState(vectors=vectors, norms=norms_bias, scales=scales,
                   n=jnp.asarray(vectors.shape[0], jnp.int32))
    # graph-engine configs say "float32" where the flat scan says "highest"
    precision = {"float32": "highest"}.get(precision, precision)
    return _search(st, q, k, metric, tile_n, approx=approx,
                   recall_target=recall_target, precision=precision)


def exact_ground_truth(corpus, queries, k: int, metric: str = "l2", tile_n: int = 65536):
    """One-shot exact kNN for recall evaluation. Returns numpy (scores, ids)."""
    corpus = jnp.asarray(corpus)
    cfg = FlatConfig(dim=int(corpus.shape[-1]), metric=metric, tile_n=tile_n)
    idx = FlatIndex(cfg, capacity=int(corpus.shape[0]))
    idx.add(corpus)
    s, i = idx.search(jnp.asarray(queries), k)
    return np.asarray(s), np.asarray(i)
