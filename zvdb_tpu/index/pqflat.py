"""PQ-flat index: product-quantized brute-force scan + optional exact refine.

The memory-scaling member of the engine family (BASELINE config 5 is a 100M
corpus; f32 storage is 51.2 GB and int8 12.8 GB, while PQ codes at n_sub=16
are 1.6 GB). Search:

    lax.scan over code tiles:
        decode tile (one-hot matmul, ops/pq.py — gather-free)
        -> dense matmul scoring vs queries (asymmetric ADC: exact query,
           decoded corpus) -> approx top-k -> running merge
    optional refine pass: gather rerank*k candidate rows from the int8/float
    refine store, exact f32 rescore, final top-k.

The two-pass structure mirrors FlatIndex's rerank path (index/flat.py
_search_rerank); the first pass here reads n_sub bytes/row instead of D*4.

API surface mirrors the engine family and the reference contract
(init/insert/search — reference src/hnsw.zig:52,73,194): batched add/search,
empty-index and k>n semantics (src/hnsw.zig:201, src/test_hnsw.zig:104-126),
dim-mismatch raises (src/hnsw.zig:184), deletes are mark-and-filter via the
norms=+inf validity bias, ids never renumber.
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
from ..ops import pq as PQ
from ..ops import topk as T
from ..utils.config import PQConfig, config_from_dict


class PQState(NamedTuple):
    """Device-resident PQ index state (a pytree)."""

    codes: jax.Array      # [cap, S] uint8 codes; nibble-packed configs
                          # (cfg.packed: n_codes <= 16) store TRANSPOSED
                          # packed bytes [S//2, cap]
    norms: jax.Array      # [cap] f32: ||decoded row||^2 for l2, 0 for
                          # dot/cosine; +inf = uningested/tombstoned (the
                          # validity bias — same convention as FlatState)
    codebooks: jax.Array  # [S, C, dsub] f32 (frozen after training)
    rot: jax.Array        # [D, D] f32 OPQ rotation (codes live in x@rot
                          # space) or the [0, 0] identity sentinel (plain PQ)
    refine: jax.Array     # [cap, D] refine rows (int8/f32/bf16) or [cap, 0]
    r_scales: jax.Array   # [cap] f32 per-vector dequant scales (int8 refine)
    n: jax.Array          # scalar int32 slots used (including tombstones)


def init_state(capacity: int, cfg: PQConfig,
               codebooks: Optional[jax.Array] = None,
               rot: Optional[jax.Array] = None) -> PQState:
    refine_d = cfg.dim if cfg.refine != "none" else 0
    if codebooks is None:
        codebooks = jnp.zeros((cfg.n_sub, cfg.n_codes, cfg.dsub), jnp.float32)
    if rot is None:
        rot = jnp.zeros((0, 0), jnp.float32)
    codes_shape = ((cfg.codes_width, capacity) if cfg.packed
                   else (capacity, cfg.n_sub))
    return PQState(
        codes=jnp.zeros(codes_shape, jnp.uint8),
        norms=jnp.full((capacity,), jnp.inf, jnp.float32),
        codebooks=codebooks,
        rot=rot,
        refine=jnp.zeros((capacity, refine_d), cfg.refine_dtype),
        r_scales=jnp.ones((capacity,), jnp.float32),
        n=jnp.zeros((), jnp.int32),
    )


@functools.partial(jax.jit, static_argnames=("metric", "refine", "packed"),
                   donate_argnums=(0,))
def _ingest(state: PQState, x: jax.Array, metric: str, refine: str,
            packed: bool) -> PQState:
    # state is DONATED: the caller always rebinds (self.state = _ingest(...)),
    # and without donation a chunked 100M ingest would hold two copies of the
    # multi-GB codes+refine stores per add (XLA updates buffers in place when
    # donated — the HBM-discipline lever for the scale builds).
    xf = D.preprocess_queries(x, metric)   # f32 (+ normalize for cosine)
    # codes quantize the ROTATED rows under OPQ (rotation preserves l2/dot
    # scores, so the scan stays consistent with rotated queries); the refine
    # store below keeps the ORIGINAL rows so the rerank is exact in the
    # user's space and get() returns stored vectors verbatim.
    codes = PQ.encode(PQ.apply_rotation(xf, state.rot), state.codebooks)
    if metric == "l2":
        norms = PQ.decoded_sq_norms(codes, state.codebooks)
    else:
        norms = jnp.zeros((x.shape[0],), jnp.float32)
    if refine in ("int8", "int16"):
        rrows, rscales, _ = D.quantize_corpus(
            xf, metric, bits=8 if refine == "int8" else 16)
    elif refine == "none":
        rrows = jnp.zeros((x.shape[0], 0), jnp.float32)
        rscales = jnp.ones((x.shape[0],), jnp.float32)
    else:
        dtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[refine]
        rrows = xf.astype(dtype)
        rscales = jnp.ones((x.shape[0],), jnp.float32)
    if packed:
        new_codes = jax.lax.dynamic_update_slice(
            state.codes, PQ.pack_nibbles(codes).T, (0, state.n))
    else:
        new_codes = jax.lax.dynamic_update_slice(state.codes, codes,
                                                 (state.n, 0))
    return PQState(
        codes=new_codes,
        norms=jax.lax.dynamic_update_slice(state.norms, norms, (state.n,)),
        codebooks=state.codebooks,
        rot=state.rot,
        refine=jax.lax.dynamic_update_slice(state.refine, rrows, (state.n, 0)),
        r_scales=jax.lax.dynamic_update_slice(state.r_scales, rscales,
                                              (state.n,)),
        n=state.n + x.shape[0],
    )


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "tile_n", "approx", "recall_target",
                     "precision", "packed"),
)
def _pq_scan(
    state: PQState, qs: jax.Array, k: int, metric: str, tile_n: int,
    approx: bool, recall_target: float, precision: str, packed: bool = False,
):
    """Pass 1: tiled decode + matmul score + running top-k over PQ codes.

    Returns (surrogate scores [B, k], ids [B, k]); invalid slots id -1,
    score +inf. Same scan/merge skeleton as flat._search, with the tile's
    vectors produced by the one-hot decode instead of read from storage.
    packed: codes are the transposed nibble layout [S//2, cap] (unpacked
    per tile).
    """
    cap = state.codes.shape[1] if packed else state.codes.shape[0]
    tile = min(tile_n, cap)
    n_tiles = -(-cap // tile)
    pad_cap = n_tiles * tile
    b = qs.shape[0]

    if packed:
        n_sub = 2 * state.codes.shape[0]
        code_t = jnp.pad(state.codes, ((0, 0), (0, pad_cap - cap))).reshape(
            -1, n_tiles, tile).transpose(1, 0, 2)        # [T, S//2, tile]
    else:
        code_t = jnp.pad(state.codes, ((0, pad_cap - cap), (0, 0))).reshape(
            n_tiles, tile, -1)
    norm_t = jnp.pad(state.norms, (0, pad_cap - cap),
                     constant_values=jnp.inf).reshape(n_tiles, tile)
    prec = D.matmul_precision(precision)

    init = (
        jnp.full((b, k), jnp.inf, jnp.float32),
        jnp.full((b, k), -1, jnp.int32),
    )

    def body(carry, inputs):
        t_idx, codes, norms = inputs
        best_s, best_i = carry
        if packed:
            codes = PQ.unpack_nibbles(codes.T, n_sub)    # [tile, S]
        xhat = PQ.decode(codes, state.codebooks)         # [tile, D] f32
        s = D.pairwise_scores(qs, xhat, norms, metric, precision=prec)
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
        body, init, (jnp.arange(n_tiles, dtype=jnp.int32), code_t, norm_t)
    )
    return best_s, best_i


@functools.partial(jax.jit, static_argnames=("k", "cfg", "approx"))
def _pq_search(state: PQState, q: jax.Array, k: int, cfg, approx: bool):
    """Full search: PQ scan (+ exact refine rerank when a refine store
    exists). Returns user-facing (scores, ids). cfg is the frozen PQConfig
    (hashable — a static arg). approx selects approx_min_k or exact top_k
    in the scan (both remain approximate w.r.t. the original vectors —
    PQ quantization; the refine rerank repairs ranking)."""
    metric, refine, rerank = cfg.metric, cfg.refine, cfg.rerank
    qs = D.preprocess_queries(q, metric)
    # scan pass runs in the (possibly OPQ-rotated) code space; the refine
    # rerank below scores the ORIGINAL qs against the original-space refine
    # store. ||qr|| == ||qs||, so finalize_scores works on either.
    qr = PQ.apply_rotation(qs, state.rot)
    kk = k if refine == "none" else max(k * rerank, k)

    s1, i1 = _pq_scan(state, qr, kk, metric, cfg.tile_n, approx,
                      cfg.recall_target, cfg.precision, packed=cfg.packed)

    if refine == "none":
        best_s, best_i = s1, i1
    else:
        safe = jnp.maximum(i1, 0)
        rv = jnp.take(state.refine, safe, axis=0).astype(jnp.float32)
        if refine in ("int8", "int16"):
            rv = rv * jnp.take(state.r_scales, safe, axis=0)[..., None]
        dots = jnp.einsum("bd,bcd->bc", qs, rv,
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
        if metric == "l2":
            rn = jnp.sum(rv * rv, axis=-1)
            ex = rn - 2.0 * dots
        else:
            ex = -dots
        ex = jnp.where(i1 >= 0, ex, jnp.inf)
        best_s, best_i = T.smallest_k(ex, i1, k)
    out = D.finalize_scores(best_s, qs, metric)
    out = jnp.where(best_i >= 0, out, jnp.inf if metric == "l2" else -jnp.inf)
    return out, best_i


class PQFlatIndex:
    """Product-quantized exact-scan index (codes + optional refine store).

    API mirrors the engine family: build/add/search/remove/compact/save/
    load/get, filtered search via `allowed`. Codebooks are trained on the
    first build/add and frozen; later adds encode against them (documented
    in PQConfig). Distribution drift across adds degrades code quality, not
    correctness — rebuild to retrain.
    """

    def __init__(self, cfg: PQConfig, capacity: int = 0):
        self.cfg = cfg
        self.capacity = int(capacity)
        self.state: Optional[PQState] = (
            init_state(self.capacity, cfg) if capacity else None
        )
        self._trained = False
        self._dead: set[int] = set()
        # Guards mutations (same read-modify-write discipline as FlatIndex);
        # searches read self.state once and stay lock-free.
        self._write_lock = threading.RLock()

    def __len__(self) -> int:
        return (0 if self.state is None else int(self.state.n)) - len(self._dead)

    @property
    def dim(self) -> int:
        return self.cfg.dim

    @property
    def _n_total(self) -> int:
        return 0 if self.state is None else int(self.state.n)

    # -- construction ------------------------------------------------------

    def _train(self, xf: jax.Array) -> tuple[jax.Array, jax.Array]:
        """(codebooks, rot) from a (sampled) training batch. xf is on-device
        f32, already metric-preprocessed. rot is the [0, 0] sentinel unless
        cfg.opq."""
        cfg = self.cfg
        n = xf.shape[0]
        key = jax.random.PRNGKey(cfg.seed)
        if n > cfg.train_sample:
            sel = jax.random.choice(jax.random.fold_in(key, 1), n,
                                    (cfg.train_sample,), replace=False)
            xs = jnp.take(xf, sel, axis=0)
        else:
            xs = xf
        if cfg.opq:
            rot, cb = PQ.train_opq(xs, key, cfg.n_sub, cfg.n_codes,
                                   cfg.kmeans_iters, cfg.opq_iters)
            return cb, rot
        return (PQ.train_codebooks(xs, key, cfg.n_sub, cfg.n_codes,
                                   cfg.kmeans_iters),
                jnp.zeros((0, 0), jnp.float32))

    def _ensure_capacity(self, extra: int):
        need = self._n_total + extra
        if self.state is None:
            self.capacity = max(need, 1024)
            self.state = init_state(self.capacity, self.cfg)
        elif need > self.capacity:
            new_cap = max(need, 2 * self.capacity)
            old = self.state
            grown = init_state(new_cap, self.cfg, codebooks=old.codebooks,
                               rot=old.rot)
            if self.cfg.packed:
                new_codes = grown.codes.at[:, : self.capacity].set(old.codes)
            else:
                new_codes = grown.codes.at[: self.capacity].set(old.codes)
            self.state = PQState(
                codes=new_codes,
                norms=grown.norms.at[: self.capacity].set(old.norms),
                codebooks=old.codebooks,
                rot=old.rot,
                refine=grown.refine.at[: self.capacity].set(old.refine),
                r_scales=grown.r_scales.at[: self.capacity].set(old.r_scales),
                n=old.n,
            )
            self.capacity = new_cap

    def add(self, x) -> None:
        """Insert a batch [B, D] (or a single vector [D]). The first add on
        an untrained index trains the codebooks from this batch."""
        x = jnp.asarray(x)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[-1] != self.cfg.dim:
            raise ValueError(
                f"dimension mismatch: index dim {self.cfg.dim}, got {x.shape[-1]}"
            )
        if x.shape[0] == 0:
            return
        with self._write_lock:
            self._ensure_capacity(x.shape[0])
            if not self._trained:
                xf = D.preprocess_queries(x, self.cfg.metric)
                cb, rot = self._train(xf)
                self.state = self.state._replace(codebooks=cb, rot=rot)
                self._trained = True
            self.state = _ingest(self.state, x, self.cfg.metric,
                                 self.cfg.refine, self.cfg.packed)

    insert = add  # reference-parity alias (src/hnsw.zig:73)

    def build(self, x) -> None:
        """Replace contents with corpus x: train codebooks on a sample of x,
        then encode and ingest it (engine-uniform bulk-build API)."""
        with self._write_lock:
            self.state = None
            self.capacity = 0
            self._dead = set()
            self._trained = False
            self.add(x)

    # -- mutation ----------------------------------------------------------

    def remove(self, ids) -> int:
        """Tombstone by external id (ids never renumber — the reference's
        dense sequential ids, src/hnsw.zig:77). One scatter flips the rows'
        norm bias to +inf; both the PQ scan and the refine pass inherit the
        exclusion from pass-1 ids. Returns newly deleted count."""
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
            return len(new)

    def compact(self) -> np.ndarray:
        """Drop tombstoned rows, renumber survivors to [0, L) in former
        order; returns survivors' OLD ids. Codes move verbatim (no
        re-encode); codebooks are unchanged."""
        with self._write_lock:
            n = self._n_total
            live = np.ones(n, bool)
            if self._dead:
                live[np.fromiter(self._dead, np.int64, len(self._dead))] = False
            live_np = np.flatnonzero(live)
            if self.state is not None and live_np.size < n:
                if live_np.size == 0:
                    cb, rot = self.state.codebooks, self.state.rot
                    self.state = None
                    self.capacity = 0
                    if self._trained:
                        # keep trained codebooks for future adds
                        self.capacity = 1024
                        self.state = init_state(self.capacity, self.cfg,
                                                codebooks=cb, rot=rot)
                else:
                    rows = jnp.asarray(live_np)
                    st = self.state
                    self.state = PQState(
                        codes=jnp.take(st.codes, rows,
                                       axis=1 if self.cfg.packed else 0),
                        norms=jnp.take(st.norms, rows, axis=0),
                        codebooks=st.codebooks,
                        rot=st.rot,
                        refine=jnp.take(st.refine, rows, axis=0),
                        r_scales=jnp.take(st.r_scales, rows, axis=0),
                        n=jnp.asarray(live_np.size, jnp.int32),
                    )
                    self.capacity = int(live_np.size)
            self._dead = set()
            return live_np

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        """npz snapshot. Tombstones ride in `norms` (+inf rows)."""
        import dataclasses

        if self.state is None:
            raise ValueError("empty index")
        refine = np.asarray(self.state.refine)
        if self.state.refine.dtype == jnp.bfloat16:
            # npz stores ml_dtypes bfloat16 as raw void ('|V2') which cannot
            # be reloaded — ship the bit pattern as uint16 (lossless, same
            # bytes; the load path views it back via cfg.refine_dtype).
            refine = refine.view(np.uint16)
        np.savez(
            path,
            cfg=json.dumps(dataclasses.asdict(self.cfg)),
            capacity=np.int64(self.capacity),
            trained=np.bool_(self._trained),
            codes=np.asarray(self.state.codes),
            norms=np.asarray(self.state.norms),
            codebooks=np.asarray(self.state.codebooks),
            rot=np.asarray(self.state.rot),
            refine=refine,
            r_scales=np.asarray(self.state.r_scales),
            n=np.asarray(self.state.n),
        )

    @classmethod
    def load(cls, path: str) -> "PQFlatIndex":
        z = np.load(path, allow_pickle=False)
        cfg = config_from_dict(PQConfig, json.loads(str(z["cfg"])))
        idx = cls(cfg)
        idx.capacity = int(z["capacity"])
        idx._trained = bool(z["trained"])
        refine = z["refine"]
        if cfg.refine == "bfloat16" and refine.dtype == np.uint16:
            import ml_dtypes
            refine = refine.view(ml_dtypes.bfloat16)
        idx.state = PQState(
            codes=jnp.asarray(z["codes"]),
            norms=jnp.asarray(z["norms"]),
            codebooks=jnp.asarray(z["codebooks"]),
            # snapshots from before the OPQ field default to the sentinel
            rot=jnp.asarray(z["rot"]) if "rot" in z
            else jnp.zeros((0, 0), jnp.float32),
            refine=jnp.asarray(refine),
            r_scales=jnp.asarray(z["r_scales"]),
            n=jnp.asarray(z["n"]),
        )
        n = int(idx.state.n)
        dead = np.flatnonzero(np.isinf(np.asarray(z["norms"])[:n]))
        idx._dead = set(int(i) for i in dead)
        return idx

    # -- reads -------------------------------------------------------------

    def get(self, ids) -> np.ndarray:
        """Stored representation for external ids -> [K, D] f32. With a
        refine store this is the (near-)exact stored vector; with
        refine="none" it is the PQ reconstruction (document-level
        approximation — the codes ARE the storage)."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        n = self._n_total
        if ids.size == 0:
            return np.zeros((0, self.cfg.dim), np.float32)
        if (ids < 0).any() or (ids >= n).any():
            raise IndexError(f"ids must be in [0, {n})")
        if self._dead and any(int(i) in self._dead for i in ids):
            raise IndexError("id was deleted")
        rows = jnp.asarray(ids)
        if self.cfg.refine != "none":
            vecs = jnp.take(self.state.refine, rows, axis=0).astype(jnp.float32)
            if self.cfg.refine in ("int8", "int16"):
                vecs = vecs * jnp.take(self.state.r_scales, rows)[:, None]
            return np.asarray(vecs)
        if self.cfg.packed:
            codes = PQ.unpack_nibbles(
                jnp.take(self.state.codes, rows, axis=1).T, self.cfg.n_sub)
        else:
            codes = jnp.take(self.state.codes, rows, axis=0)
        dec = PQ.decode(codes, self.state.codebooks)
        # OPQ codes reconstruct x@rot; rotate back to the user's space
        # (rot is orthogonal, so rot.T is its inverse)
        return np.asarray(PQ.apply_rotation(dec, self.state.rot.T))

    def search(self, q, k: int, approx: bool = True, allowed=None,
               rerank: int | None = None):
        """Top-k. q: [B, D] or [D]. Returns (scores [B,k], ids [B,k]).

        rerank: per-call override of cfg.rerank (refine-pool depth = k *
        rerank) — the recall/QPS knob, same per-call-override convention as
        the graph engines' ef_search/search_degree. Each distinct value is
        its own compiled program.

        approx=True (default): approx_min_k partial-reduce top-k in the
        scan pass. approx=False: full-sort selection over the PQ scores — both
        are approximate relative to the original vectors (PQ quantization);
        the refine rerank (cfg.refine != "none") repairs ranking against the
        refine store.

        allowed: optional allowlist (bool mask over ids, or an int id
        array); exact filtering at any selectivity — the scan scores all
        rows and the filter is one validity-bias mask. The candidate pool
        entering the refine pass is post-filter, so no pool loss either.

        Empty index -> all ids -1 (reference src/hnsw.zig:201); k > n ->
        trailing ids -1 (src/test_hnsw.zig:104-126).
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
        if state is not None and allowed is not None:
            from ..utils.masks import allowed_mask

            mask = allowed_mask(allowed, self._n_total, state.norms.shape[0])
            state = state._replace(
                norms=jnp.where(mask, state.norms, jnp.inf))
        if state is None or not self._trained:
            s = jnp.full((q.shape[0], k), jnp.inf, jnp.float32)
            i = jnp.full((q.shape[0], k), -1, jnp.int32)
        else:
            cfg = self.cfg
            if rerank is not None and rerank != cfg.rerank:
                import dataclasses

                cfg = dataclasses.replace(cfg, rerank=rerank)
            s, i = _pq_search(state, q, k, cfg, approx)
        if squeeze:
            return s[0], i[0]
        return s, i
