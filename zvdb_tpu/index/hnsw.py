"""HNSW on an accelerator: flat int32 neighbor tables + batched hierarchical beam search.

Re-architecture of the reference's pointer-chasing index (reference
src/hnsw.zig:8-247). The reference keeps a hash map of heap-allocated nodes with
per-node ArrayList adjacency and traverses with a priority queue under a global
mutex; none of that maps to an accelerator. Here the index is a pytree of
dense arrays:

    vectors  f32/bf16 [cap, D]
    norms    f32      [cap]            (squared norms, l2 metric only)
    nbr0     int32    [cap+1, M0]      base-layer adjacency, -1 padded
    nbrU     int32    [L, cap+1, M]    upper-layer adjacency (layer l at nbrU[l-1])
    levels   int32    [cap]            per-node level (-1 = unused slot)
    ext_ids  int32    [cap]            user-visible id of each internal row

and search is a batched beam search: per hop, gather neighbor rows -> gather
candidate vectors -> one batched contraction for all scores (matmul) -> masked
top-k merge. The +1 row in the adjacency tables is a write-trash row so batched
scatters can drop invalid updates without dynamic shapes.

Deliberate fixes over the reference (SURVEY.md §2.1 / fidelity ledger):
  * search uses the hierarchy (reference searches layer-0 only, src/hnsw.zig:216)
  * real ef_search beam (reference terminates after popping k, src/hnsw.zig:211)
  * entry point promoted when a higher-level node arrives (reference never
    promotes, src/hnsw.zig:110-116)
  * canonical level distribution mL=1/ln(m) (reference p=0.5, src/hnsw.zig:176)
  * descent goes top layer -> 0 (reference ascends, src/hnsw.zig:88)
"""
from __future__ import annotations

import math
import threading
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import distance as D
from ..ops import topk as T
from ..utils.config import HNSWConfig, SearchConfig

INF = jnp.inf


class HNSWState(NamedTuple):
    vectors: jax.Array    # [cap, D] storage dtype
    norms: jax.Array      # [cap] f32
    nbr0: jax.Array       # [cap+1, M0] int32
    nbrU: jax.Array       # [L, cap+1, M] int32
    # True metric distance of each edge (squared L2, or -dot), +inf padded.
    # Stored so reverse-edge re-pruning during build needs NO vector gathers
    # (row gathers are a graph search's bottleneck).
    dist0: jax.Array      # [cap+1, M0] f32
    distU: jax.Array      # [L, cap+1, M] f32
    levels: jax.Array     # [cap] int32, -1 unused
    ext_ids: jax.Array    # [cap] int32
    entry: jax.Array      # scalar int32 internal row (-1 = empty)
    max_level: jax.Array  # scalar int32
    n: jax.Array          # scalar int32 live count
    # Per-tensor int8 dequant scale (1.0 for float dtypes): x ~= q_scale*codes.
    # Per-TENSOR, not per-vector, deliberately: a per-vector scale array would
    # add one more row gather per hop.
    # This is the idiomatic analog of the reference's HNSW(i32) instantiation
    # (src/test_hnsw.zig:239-273).
    q_scale: jax.Array    # scalar f32
    # Anchor seed table (may be empty [0, D] -> seeding disabled): a random
    # ~n/12 sample of stored rows kept DENSE so one [B, A] matmul ranks
    # them per query. The best anchor is ~the (n/A)-th nearest neighbor, so
    # the layer-0 beam starts inside the answer's neighborhood even when the
    # greedy descent strands in a far micro-cluster (measured: descent-only
    # search capped at ~0.63 recall on 10k-micro-cluster data; anchor-seeded
    # reaches ~0.98). Matmul flops are cheap; the hops they replace cost
    # row gathers — the scarce resource.
    anchors: jax.Array    # [A, D] f32 dequantized copies of anchor rows
    a_norms: jax.Array    # [A] f32
    a_rows: jax.Array     # [A] int32


def max_level_for(capacity: int, m: int) -> int:
    """Static hierarchy height: enough layers that the top layer is ~O(1) nodes."""
    if capacity <= 1:
        return 1
    return max(1, int(math.ceil(math.log(max(capacity, 2)) / math.log(max(m, 2)))))


def init_state(capacity: int, cfg: HNSWConfig, levels_cap: Optional[int] = None) -> HNSWState:
    L = levels_cap if levels_cap is not None else (
        cfg.max_level if cfg.max_level is not None else max_level_for(capacity, cfg.m)
    )
    return HNSWState(
        vectors=jnp.zeros((capacity, cfg.dim), cfg.storage_dtype),
        norms=jnp.zeros((capacity,), jnp.float32),
        nbr0=jnp.full((capacity + 1, cfg.base_degree), -1, jnp.int32),
        nbrU=jnp.full((L, capacity + 1, cfg.m), -1, jnp.int32),
        dist0=jnp.full((capacity + 1, cfg.base_degree), jnp.inf, jnp.float32),
        distU=jnp.full((L, capacity + 1, cfg.m), jnp.inf, jnp.float32),
        levels=jnp.full((capacity,), -1, jnp.int32),
        ext_ids=jnp.full((capacity,), -1, jnp.int32),
        entry=jnp.asarray(-1, jnp.int32),
        max_level=jnp.asarray(0, jnp.int32),
        n=jnp.asarray(0, jnp.int32),
        q_scale=jnp.asarray(1.0, jnp.float32),
        anchors=jnp.zeros((0, cfg.dim), jnp.float32),
        a_norms=jnp.zeros((0,), jnp.float32),
        a_rows=jnp.zeros((0,), jnp.int32),
    )


# ---------------------------------------------------------------------------
# score helpers


def _gather_vecs(state: HNSWState, rows: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Gather vectors+norms for row ids (any shape); -1 rows are clamped (callers mask)."""
    safe = jnp.maximum(rows, 0)
    return jnp.take(state.vectors, safe, axis=0), jnp.take(state.norms, safe, axis=0)


def _scores_to(state: HNSWState, q: jax.Array, rows: jax.Array, metric: str) -> jax.Array:
    """Surrogate scores from queries [B, D] to per-query rows [B, C] -> [B, C].

    Invalid rows (< 0 or >= limit handled by caller) get +inf here only for < 0.
    """
    vecs, norms = _gather_vecs(state, rows)
    s = D.gathered_scores(q, vecs, norms, metric, scale=state.q_scale)
    return jnp.where(rows >= 0, s, INF)


# ---------------------------------------------------------------------------
# greedy descent over one upper layer


def make_scorer(state, q: jax.Array, metric: str):
    """Row-scoring closure rows [B, C] -> surrogate scores [B, C] for a fixed
    (state, preprocessed-query-batch, metric). The beam/greedy kernels are
    written against this interface so alternative storage layouts (e.g. the
    CAGRA engine's packed norm column) plug in without touching the loops."""
    return lambda rows: _scores_to(state, q, rows, metric)


def make_packed_scorer(table: jax.Array, qp: jax.Array):
    """One-gather scorer over the packed [cap, D+1] (vector ‖ squared-norm)
    table — the CAGRA hop-bandwidth layout applied to HNSW (l2 + f32 only).

    score = ||x||^2 - 2 q.x = -2 * ([q, -0.5] . [x, ||x||^2]), so the fused
    row needs no separate norm gather: each hop costs ONE row gather instead
    of two (the extra norm column rides the same row; a second gather does
    not)."""
    b = qp.shape[0]
    qe = jnp.concatenate([qp, jnp.full((b, 1), -0.5, jnp.float32)], axis=1)

    def score_rows(rows):
        safe = jnp.maximum(rows, 0)
        vx = jnp.take(table, safe, axis=0)                 # ONE gather
        dots = jnp.einsum("bd,bcd->bc", qe, vx,
                          preferred_element_type=jnp.float32)
        return jnp.where(rows >= 0, -2.0 * dots, INF)

    return score_rows


def _greedy_layer_fn(
    score_rows,              # rows [B, C] -> scores [B, C]
    ep: jax.Array,           # [B] int32 current entry rows
    ep_score: jax.Array,     # [B] f32
    nbrs: jax.Array,         # [cap+1, M] adjacency of this layer
    max_iters: int,
):
    """Batched greedy walk: move each query to its best neighbor until no improvement."""

    def cond(carry):
        _, _, moved, it = carry
        return jnp.logical_and(jnp.any(moved), it < max_iters)

    def body(carry):
        ep, ep_score, _, it = carry
        cand = jnp.take(nbrs, jnp.maximum(ep, 0), axis=0)  # [B, M]
        s = score_rows(cand)
        best_s = jnp.min(s, axis=-1)
        best_i = jnp.argmin(s, axis=-1)
        best_row = jnp.take_along_axis(cand, best_i[:, None], axis=-1)[:, 0]
        better = best_s < ep_score
        new_ep = jnp.where(better, best_row, ep)
        new_score = jnp.where(better, best_s, ep_score)
        return new_ep, new_score, better, it + 1

    init = (ep, ep_score, jnp.ones(ep.shape, bool), jnp.asarray(0, jnp.int32))
    ep, ep_score, _, _ = jax.lax.while_loop(cond, body, init)
    return ep, ep_score


def _greedy_layer(state, q, ep, ep_score, nbrs, metric, max_iters):
    """Back-compat wrapper over _greedy_layer_fn with the HNSW state scorer."""
    return _greedy_layer_fn(make_scorer(state, q, metric), ep, ep_score, nbrs, max_iters)


# ---------------------------------------------------------------------------
# beam search over one layer


def beam_layer_fn(
    score_rows,               # rows [B, C] -> surrogate scores [B, C]
    seed_rows: jax.Array,     # [B, S] initial candidate rows (-1 ok)
    seed_scores: jax.Array,   # [B, S]
    nbrs: jax.Array,          # [cap+1, deg] adjacency for this layer
    ef: int,
    expand: int = 1,
    max_iters: Optional[int] = None,
    limit_n: Optional[jax.Array] = None,
    use_degree: Optional[int] = None,
    dedupe_candidates: bool = True,
    expand_fn=None,
):
    """Batched best-first beam search on one layer's graph.

    Returns (beam_scores [B, ef], beam_rows [B, ef]) sorted ascending by score.
    `limit_n`: rows >= limit_n are treated as nonexistent (used during bulk build
    to search only the frozen prefix).

    `expand_fn`: optional override of the adjacency-gather + score step —
    sel_r [B, E] -> (cand_ids [B, C], cand_scores [B, C]) with invalid slots
    (-1, +inf). Used by the fat-row engines where one gather yields neighbor
    ids, vectors, and norms together (fusing the three tables into one row
    cuts the gathers per hop).

    This replaces the reference's heap + visited-hashmap loop
    (src/hnsw.zig:202-224). The visited set is implicit: candidates are deduped
    against the current beam and carry an expanded flag; an evicted-then-revisited
    node costs a little wasted compute, never correctness.
    """
    b, s_width = seed_rows.shape
    deg = nbrs.shape[-1]
    e = expand
    if max_iters is None:
        # Hop budget: each iteration expands `e` beam entries, so ~ef/e
        # iterations visit a full beam's worth; +4 covers seeding slack.
        # Stragglers keep the whole batch iterating (while_loop exits only
        # when every query converges), so a tight cap matters for throughput.
        # Measured (100k clustered, anchor-seeded): recall flat from
        # ~ef/e+2 hops; on UNIFORM data at ef=128 the budget must scale with
        # ef (a fixed cap of 8 cost 7 recall points), hence derived-not-fixed.
        # +8 (not +4): small degraded graphs (heavy incremental insert at
        # tiny m) measured 0.78 self-hit at +4 vs 0.91 at +8 — the extra
        # hops no-op early on easy corpora (converged queries freeze).
        max_iters = max(ef // max(e, 1), 1) + 8

    # init beam from seeds
    pad = ef - s_width
    if pad < 0:
        seed_scores, seed_rows = T.smallest_k(seed_scores, seed_rows, ef)
        pad = 0
    beam_s = jnp.pad(seed_scores, ((0, 0), (0, pad)), constant_values=INF)
    beam_r = jnp.pad(seed_rows, ((0, 0), (0, pad)), constant_values=-1)
    beam_s, beam_r = T.mask_duplicate_ids(beam_s, beam_r)
    beam_s, beam_r = T.smallest_k(beam_s, beam_r, ef)
    expanded = beam_r < 0  # invalid slots count as expanded

    def cond(carry):
        _, _, expanded, it, done = carry
        return jnp.logical_and(it < max_iters, jnp.logical_not(jnp.all(done)))

    def body(carry):
        beam_s, beam_r, expanded, it, done = carry
        unexp_s = jnp.where(expanded, INF, beam_s)
        # positions of the E best unexpanded entries
        _, pos = jax.lax.top_k(-unexp_s, e)                       # [B, E]
        sel_s = jnp.take_along_axis(unexp_s, pos, axis=-1)        # [B, E]
        sel_r = jnp.take_along_axis(beam_r, pos, axis=-1)
        sel_valid = jnp.isfinite(sel_s)
        sel_r = jnp.where(sel_valid, sel_r, -1)

        # termination: best unexpanded no better than the worst beam slot
        worst = jnp.max(beam_s, axis=-1)
        best_unexp = sel_s[:, 0]
        q_done = best_unexp >= worst
        new_done = jnp.logical_or(done, q_done)

        # mark selected as expanded
        onehot = jnp.zeros_like(expanded).at[
            jnp.arange(b)[:, None], pos
        ].set(True, mode="drop")
        onehot = jnp.logical_and(onehot, jnp.isfinite(jnp.where(expanded, INF, beam_s)))
        expanded = jnp.logical_or(expanded, onehot)

        # expand: gather neighbor lists of the selected rows
        if expand_fn is not None:
            cand, c_s = expand_fn(sel_r)
        else:
            cand = jnp.take(nbrs, jnp.maximum(sel_r, 0), axis=0)  # [B, E, deg]
            if use_degree is not None and use_degree < deg:
                # rows are distance/priority-sorted at build time; truncating
                # the tail halves the vector-gather row count (the hop's
                # dominant cost) for a
                # small recall hit
                cand = cand[:, :, :use_degree]
            cand = jnp.where((sel_r >= 0)[:, :, None], cand, -1)
            cand = cand.reshape(b, -1)
            if limit_n is not None:
                cand = jnp.where(cand < limit_n, cand, -1)
            c_s = score_rows(cand)
        if dedupe_candidates:
            # exact in-hop dedupe: O(C^2) bool matrix — at large B this
            # materializes GBs per hop; disable to trade a little beam
            # capacity (duplicate slots) for much cheaper hops
            c_s, cand = T.mask_duplicate_ids(c_s, cand)
        c_s, cand = T.mask_ids_in(c_s, cand, beam_r)

        # merge into beam, carrying expanded flags (new entries unexpanded)
        all_s = jnp.concatenate([beam_s, c_s], axis=-1)
        all_r = jnp.concatenate([beam_r, cand], axis=-1)
        all_e = jnp.concatenate(
            [expanded, jnp.zeros_like(cand, bool)], axis=-1
        )
        _, top_pos = jax.lax.top_k(-all_s, ef)
        beam_s = jnp.take_along_axis(all_s, top_pos, axis=-1)
        beam_r = jnp.take_along_axis(all_r, top_pos, axis=-1)
        expanded = jnp.take_along_axis(all_e, top_pos, axis=-1)
        expanded = jnp.logical_or(expanded, beam_r < 0)
        # frozen queries keep everything expanded so they do no further work
        expanded = jnp.logical_or(expanded, new_done[:, None])
        return beam_s, beam_r, expanded, it + 1, new_done

    init = (beam_s, beam_r, expanded, jnp.asarray(0, jnp.int32), jnp.zeros(b, bool))
    beam_s, beam_r, *_ = jax.lax.while_loop(cond, body, init)
    return beam_s, beam_r


def beam_layer(
    state: HNSWState,
    q: jax.Array,
    seed_rows: jax.Array,
    seed_scores: jax.Array,
    nbrs: jax.Array,
    ef: int,
    metric: str,
    expand: int = 1,
    max_iters: Optional[int] = None,
    limit_n: Optional[jax.Array] = None,
    use_degree: Optional[int] = None,
    dedupe_candidates: bool = True,
):
    """beam_layer_fn with the HNSW state scorer (back-compat surface)."""
    return beam_layer_fn(
        make_scorer(state, q, metric), seed_rows, seed_scores, nbrs, ef,
        expand=expand, max_iters=max_iters, limit_n=limit_n,
        use_degree=use_degree, dedupe_candidates=dedupe_candidates,
    )


# ---------------------------------------------------------------------------
# full hierarchical search


def descend(
    state: HNSWState,
    q: jax.Array,
    metric: str,
    levels_cap: int,
    stop_layer: int = 0,
    max_upper_iters: int = 32,
    limit_n: Optional[jax.Array] = None,
    scorer=None,
):
    """Greedy-descend from the entry point through upper layers down to
    `stop_layer + 1`, returning per-query entry rows+scores for `stop_layer`.
    `scorer`: optional row-scoring closure override (packed layout)."""
    b = q.shape[0]
    if scorer is None:
        scorer = make_scorer(state, q, metric)
    ep = jnp.broadcast_to(state.entry, (b,))
    ep_score = scorer(ep[:, None])[:, 0]
    for ell in range(levels_cap, stop_layer, -1):
        active = ell <= state.max_level
        nbrs = state.nbrU[ell - 1]

        def run(args, nbrs=nbrs):
            ep, ep_score = args
            return _greedy_layer_fn(scorer, ep, ep_score, nbrs, max_upper_iters)

        ep, ep_score = jax.lax.cond(active, run, lambda a: a, (ep, ep_score))
    return ep, ep_score


def search_state_impl(
    state: HNSWState,
    q: jax.Array,      # [B, D] raw queries
    k: int,
    metric: str,
    ef: int,
    expand: int = 1,
    max_iters: Optional[int] = None,
    max_upper_iters: int = 32,
    levels_cap: int = 1,
    precision: str = "float32",
    search_degree: Optional[int] = None,
    dedupe_candidates: bool = True,
    seed_anchors: int = 16,
    dead: Optional[jax.Array] = None,
    packed_table: Optional[jax.Array] = None,
):
    """Full hierarchical kNN search. Returns (scores [B,k], ext_ids [B,k], rows [B,k]).

    scores are user-facing (squared L2 per the reference contract, or similarity
    for dot/cosine). Empty slots: score inf/-inf, ids -1. `dead`: optional
    [cap+1] bool tombstone mask by internal row — tombstoned nodes route
    beams but never enter results (mark-and-filter delete).
    `packed_table`: optional [cap, D+1] (vector ‖ norm) layout (l2+f32 only)
    — every hop on every layer then costs ONE row gather instead of two.
    """
    with D.precision_context(precision):
        return _search_state_body(
            state, q, k, metric, ef, expand, max_iters, max_upper_iters,
            levels_cap, search_degree, dedupe_candidates, seed_anchors,
            dead, packed_table,
        )


def _search_state_body(
    state, q, k, metric, ef, expand, max_iters, max_upper_iters, levels_cap,
    search_degree=None, dedupe_candidates=True, seed_anchors=16, dead=None,
    packed_table=None,
):
    qp = D.preprocess_queries(q, metric)
    ef = max(ef, k)
    scorer = (make_packed_scorer(packed_table, qp) if packed_table is not None
              else make_scorer(state, qp, metric))
    ep, ep_score = descend(
        state, qp, metric, levels_cap, stop_layer=0, max_upper_iters=max_upper_iters,
        limit_n=None, scorer=scorer,
    )
    seeds, seed_s = ep[:, None], ep_score[:, None]
    if seed_anchors > 0 and state.anchors.shape[0] > 0:
        # union descent result with the top anchor rows (one [B, A] matmul;
        # anchors hold exact dequantized vectors so their scores need no gather)
        a_s = D.pairwise_scores(qp, state.anchors, state.a_norms, metric)
        s_count = min(seed_anchors, state.anchors.shape[0])
        neg, top = jax.lax.top_k(-a_s, s_count)
        seeds = jnp.concatenate([seeds, jnp.take(state.a_rows, top)], axis=1)
        seed_s = jnp.concatenate([seed_s, -neg], axis=1)
    beam_s, beam_r = beam_layer_fn(
        scorer, seeds, seed_s, state.nbr0, ef,
        expand=expand, max_iters=max_iters, use_degree=search_degree,
        dedupe_candidates=dedupe_candidates,
    )
    # final dedupe on the (small) beam: results must be unique ids even when
    # in-hop dedupe is disabled for speed
    beam_s, beam_r = T.mask_duplicate_ids(beam_s, beam_r)
    if dead is not None:
        hit = jnp.take(dead, jnp.maximum(beam_r, 0)) & (beam_r >= 0)
        beam_s = jnp.where(hit, INF, beam_s)
        beam_r = jnp.where(hit, -1, beam_r)
    top_s, top_r = T.smallest_k(beam_s, beam_r, k)
    valid = top_r >= 0
    ext = jnp.where(valid, jnp.take(state.ext_ids, jnp.maximum(top_r, 0)), -1)
    user = D.finalize_scores(top_s, qp, metric)
    user = jnp.where(valid, user, INF if metric == "l2" else -INF)
    # empty index: entry == -1 -> everything invalid
    nonempty = state.n > 0
    ext = jnp.where(nonempty, ext, -1)
    top_r = jnp.where(nonempty, top_r, -1)
    return user, ext, top_r


search_state = jax.jit(
    search_state_impl,
    static_argnames=(
        "k", "metric", "ef", "expand", "max_iters", "max_upper_iters",
        "levels_cap", "precision", "search_degree", "dedupe_candidates",
        "seed_anchors",
    ),
)


# ---------------------------------------------------------------------------
# OO wrapper — the reference-parity public API


class HNSW:
    """HNSW index.

    API parity with the reference (src/hnsw.zig): `insert` (single or batch),
    `search`, plus what the reference lacks: batched bulk build, save/load,
    metrics beyond L2, ef_search. Host-side mutation is guarded by a lock
    (the reference serializes with a global mutex, src/hnsw.zig:50; device
    compute here is pure so the lock only protects Python state).
    """

    def __init__(
        self,
        cfg: HNSWConfig,
        search_cfg: SearchConfig = SearchConfig(),
        capacity: int = 0,
        seed: int = 0,
    ):
        self.cfg = cfg
        self.search_cfg = search_cfg
        self.capacity = int(capacity)
        self.levels_cap = cfg.max_level or max_level_for(max(capacity, 1024), cfg.m)
        self.state: Optional[HNSWState] = None
        self._pending: list[np.ndarray] = []   # host-side insert buffer
        self._n_inserted = 0                   # external ids handed out
        self._anchor_n = 0                     # n at last anchor snapshot
        self._key = jax.random.PRNGKey(seed)
        self._lock = threading.RLock()
        self._dead: set[int] = set()           # tombstoned EXTERNAL ids
        self._dead_rows: Optional[jax.Array] = None  # [cap+1] bool by row
        # derived packed [cap, D+1] search table (cfg.packed); rebuilt lazily
        # whenever state.vectors is replaced (identity-checked in search())
        self._packed_table: Optional[jax.Array] = None
        self._packed_src: Optional[jax.Array] = None
        if capacity:
            self.state = init_state(self.capacity, cfg, self.levels_cap)

    # -- introspection ----------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            n_dev = 0 if self.state is None else int(self.state.n)
            n_pend = sum(p.shape[0] for p in self._pending)
            return n_dev + n_pend - len(self._dead)

    @property
    def dim(self) -> int:
        return self.cfg.dim

    # -- mutation ---------------------------------------------------------
    def insert(self, x) -> None:
        """Insert one vector [D] or a batch [B, D]. Buffered host-side; the graph
        is extended in bulk on the next search/flush (semantically equivalent to
        the reference's per-insert mutation, minus the locks)."""
        # Own a copy — the reference copies the caller's point into index-owned
        # memory (src/hnsw.zig:24-26); buffering by reference would alias.
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
            pend = sum(p.shape[0] for p in self._pending)
            if pend >= self.cfg.build_batch:
                self._flush_locked()

    add = insert

    def build(self, x, sort_by_level: bool = True,
              checkpoint_path: Optional[str] = None,
              checkpoint_every: int = 0) -> None:
        """Bulk-build the index from a corpus [N, D] (replaces current contents).

        checkpoint_path: crash recovery via HNSW.resume_build(path).
        * batched path (build_mode="batched", or "auto" with a checkpoint):
          snapshots the partial graph every checkpoint_every batches.
        * oneshot path (build_mode="oneshot"): snapshots once after the
          base-layer graph — the dominant cost — and resume reruns only the
          upper-layer/anchor epilogue."""
        from .build import bulk_build, bulk_build_oneshot  # local: avoid cycle

        mode = self.cfg.build_mode
        oneshot = mode == "oneshot" or (mode == "auto" and not checkpoint_path)
        # device-resident corpora stay on device through the oneshot build
        # (pulling them here would cost a download AND a re-upload);
        # the batched path is host-driven and still needs numpy
        if not (oneshot and isinstance(x, jax.Array)):
            x = np.asarray(x, dtype=np.float32)
        if x.shape[0] == 0:   # empty corpus -> empty index
            with self._lock:
                self._pending = []
                self._n_inserted = 0
                self.state = None
                self.capacity = 0
                self._dead = set()
                self._dead_rows = None
            return
        with self._lock:
            self._pending = []
            self._n_inserted = x.shape[0]
            self._dead = set()
            self._dead_rows = None
            self._key, sub = jax.random.split(self._key)
            if oneshot:
                self.state, self.capacity, self.levels_cap = bulk_build_oneshot(
                    x, self.cfg, sub, checkpoint_path=checkpoint_path,
                )
            else:
                self.state, self.capacity, self.levels_cap = bulk_build(
                    x, self.cfg, sub, sort_by_level=sort_by_level,
                    checkpoint_path=checkpoint_path,
                    checkpoint_every=checkpoint_every,
                )
            self._anchor_n = x.shape[0]

    @classmethod
    def resume_build(cls, checkpoint_path: str) -> "HNSW":
        """Finish a bulk build from a crash checkpoint (SURVEY.md §5: the
        reference has no failure recovery). Dispatches on the checkpoint kind
        (batched per-K-batches snapshot vs oneshot base-layer snapshot)."""
        import json

        from .build import resume_build, resume_build_oneshot

        with np.load(checkpoint_path, allow_pickle=False) as z:
            kind = json.loads(str(z["meta"])).get("kind")
        if kind == "hnsw_oneshot":
            state, capacity, levels_cap, cfg = resume_build_oneshot(checkpoint_path)
        else:
            state, capacity, levels_cap, cfg = resume_build(checkpoint_path)
        idx = cls(cfg)
        idx.state = state
        idx.capacity = capacity
        idx.levels_cap = levels_cap
        idx._n_inserted = int(state.n)
        idx._anchor_n = int(state.n)
        return idx

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._pending:
            return
        from .build import extend_graph

        x = np.concatenate(self._pending, axis=0)
        self._pending = []
        base_ext = self._n_inserted - x.shape[0]
        self._key, sub = jax.random.split(self._key)
        self.state, self.capacity = extend_graph(
            self.state, self.capacity, self.levels_cap, x, self.cfg, sub,
            ext_id_start=base_ext,
        )
        # Anchor refresh on growth: the seed table was sampled over the rows
        # present at the last snapshot; once n doubles past it, beams on an
        # ever-grown index would seed only from the original corpus region.
        n_now = int(self.state.n)
        if self._anchor_n == 0:
            self._anchor_n = n_now   # first flush built from scratch
        elif n_now >= 2 * self._anchor_n:
            from .build import _attach_anchors

            self._key, ksub = jax.random.split(self._key)
            self.state = _attach_anchors(self.state, n_now, ksub)
            self._anchor_n = n_now

    # -- search -----------------------------------------------------------
    def _ext_to_rows(self, ext_ids_np: np.ndarray) -> np.ndarray:
        """Map external ids -> internal rows via the stored ext_ids table."""
        ext = np.asarray(self.state.ext_ids)
        live = ext >= 0
        inv = np.full(max(self._n_inserted, 1), -1, np.int64)
        inv[ext[live]] = np.nonzero(live)[0]
        return inv[ext_ids_np]

    def remove(self, ids) -> int:
        """Delete by external id (mark-and-filter; the reference has no
        delete — src/hnsw.zig:77's dense ids are safe only because nothing
        is removed). Ids never renumber; freed slots are not reused.
        Tombstoned nodes stay in the graph as traversal waypoints and are
        filtered from the final beam only, so survivor recall holds.
        Reclaim capacity with compact(). Returns #newly deleted."""
        ids = np.unique(np.atleast_1d(np.asarray(ids, np.int64)))
        if ids.size == 0:
            return 0
        with self._lock:
            self._flush_locked()
            if (ids < 0).any() or (ids >= self._n_inserted).any():
                raise IndexError(f"ids must be in [0, {self._n_inserted})")
            new = np.asarray(
                [int(i) for i in ids if int(i) not in self._dead], np.int64)
            if new.size == 0:
                return 0
            rows = self._ext_to_rows(new)
            assert (rows >= 0).all()
            cap1 = self.state.nbr0.shape[0]        # cap + trash row
            if self._dead_rows is None or self._dead_rows.shape[0] < cap1:
                base = jnp.zeros((cap1,), bool)
                if self._dead_rows is not None:
                    base = base.at[: self._dead_rows.shape[0]].set(
                        self._dead_rows)
                self._dead_rows = base
            self._dead_rows = self._dead_rows.at[jnp.asarray(rows)].set(True)
            self._dead.update(int(i) for i in new)
            return int(new.size)

    def compact(self) -> np.ndarray:
        """Rebuild without tombstoned rows; survivors renumber to [0, L) in
        former external-id order. Returns the survivors' OLD external ids
        (new_id == position). One bulk build — cheap on this engine."""
        with self._lock:
            self._flush_locked()
            alive = np.ones(self._n_inserted, bool)
            if self._dead:
                alive[np.fromiter(self._dead, np.int64, len(self._dead))] = False
            live = np.flatnonzero(alive)
            if self.state is None or len(self._dead) == 0:
                return live
            rows = self._ext_to_rows(live)
            vecs = jnp.take(
                self.state.vectors, jnp.asarray(rows), axis=0
            ).astype(jnp.float32)
            if self.cfg.dtype == "int8":
                vecs = vecs * self.state.q_scale
        self.build(vecs)
        return live

    def search(self, q, k: int, ef_search: Optional[int] = None,
               search_degree: Optional[int] = None,
               max_iters: Optional[int] = None, allowed=None,
               filter_mode: str = "auto"):
        """kNN search. q: [D] or [B, D]. Returns (scores, ids) with shape [B, k]
        ([k] for a single query). Trailing invalid slots have id -1 (the
        reference returns fewer-than-k results when n < k,
        src/test_hnsw.zig:104-126 — fixed shapes + -1 is the batched analog).
        ef_search / search_degree / max_iters override search_cfg per call
        (search-time-only knobs; each distinct combination is its own
        compiled program).
        allowed: optional allowlist over EXTERNAL ids (bool mask or int id
        array). filter_mode "auto" (default) routes per call: "scan" unless
        the corpus is past the measured crossover AND the filter is
        near-all-pass (utils/filter_policy.py). "scan" answers the filtered
        query with an EXACT masked brute-force scan of the stored rows —
        measured round 4, the beam path loses recall catastrophically at
        <=10% selectivity (docs/PERF.md) while the scan is exact and faster
        at every selectivity. "beam": non-matching nodes keep routing the
        beam and are filtered from the final ef-wide beam (raise ef_search)."""
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
            sc = self.search_cfg
            ef = ef_search if ef_search is not None else sc.ef_search
            if self.state is None or int(self.state.n) == 0:
                s = jnp.full((q.shape[0], k), INF if self.cfg.metric == "l2" else -INF)
                i = jnp.full((q.shape[0], k), -1, jnp.int32)
            elif allowed is not None and filter_mode == "scan":
                from ..utils.masks import allowed_mask
                from .flat import masked_exact_search

                st = self.state
                cap = st.vectors.shape[0]
                av = allowed_mask(allowed, self._n_inserted, self._n_inserted)
                ext = st.ext_ids
                ok = jnp.take(av, jnp.maximum(ext, 0)) & (ext >= 0)
                if self._dead_rows is not None:
                    ok = ok & ~self._dead_rows[:cap]
                bias = jnp.where(ok, 0.0, INF)
                s, rows = masked_exact_search(
                    st.vectors, st.norms + bias,
                    jnp.broadcast_to(st.q_scale, (cap,)), q, k,
                    self.cfg.metric,
                    precision=("high" if self.cfg.precision == "default"
                               else self.cfg.precision))
                i = jnp.where(rows >= 0,
                              jnp.take(ext, jnp.maximum(rows, 0)), -1)
            else:
                dead = None
                if self._dead:
                    dead = self._dead_rows
                    cap1 = self.state.nbr0.shape[0]
                    if dead.shape[0] < cap1:   # capacity grew since remove
                        dead = jnp.zeros((cap1,), bool).at[
                            : dead.shape[0]].set(dead)
                        self._dead_rows = dead
                if allowed is not None:
                    from ..utils.masks import allowed_mask

                    # allowlist is over EXTERNAL ids; block by internal row
                    # fully on device (ext_ids gather — no host inverse
                    # table or O(cap) upload per call)
                    av = allowed_mask(allowed, self._n_inserted,
                                      self._n_inserted)
                    ext = self.state.ext_ids              # [cap] row -> ext
                    blockj = ~(jnp.take(av, jnp.maximum(ext, 0))
                               & (ext >= 0))
                    cap1 = self.state.nbr0.shape[0]
                    blockj = jnp.pad(blockj, (0, cap1 - blockj.shape[0]),
                                     constant_values=True)  # trash row
                    dead = blockj if dead is None else (dead | blockj)
                pt = None
                if self.cfg.packed:
                    if (self._packed_table is None
                            or self._packed_src is not self.state.vectors):
                        self._packed_table = jnp.concatenate(
                            [self.state.vectors, self.state.norms[:, None]],
                            axis=1)
                        self._packed_src = self.state.vectors
                    pt = self._packed_table
                s, i, _ = search_state(
                    self.state, q, k, self.cfg.metric, ef,
                    expand=sc.expand,
                    max_iters=(max_iters if max_iters is not None
                               else sc.max_iters),
                    max_upper_iters=sc.max_upper_iters, levels_cap=self.levels_cap,
                    precision=self.cfg.precision,
                    search_degree=(search_degree if search_degree is not None
                                   else sc.search_degree),
                    dedupe_candidates=sc.dedupe_candidates,
                    seed_anchors=sc.seed_anchors,
                    dead=dead,
                    packed_table=pt,
                )
            if squeeze:
                return s[0], i[0]
            return s, i

    def get(self, ids) -> np.ndarray:
        """Stored vectors for external ids [K] -> [K, D] f32.

        The reference's search returns Node copies carrying the stored point
        (src/hnsw.zig:214,235; src/test_hnsw.zig:60-66 asserts the returned
        point equals the stored vector). Values are as-stored: exact for f32,
        rounded for bf16, dequantized (q_scale*codes) for int8, and normalized
        for the cosine metric."""
        with self._lock:
            self._flush_locked()
            ids = np.atleast_1d(np.asarray(ids, np.int64))
            if ids.size == 0 or self.state is None:
                if ids.size and self.state is None:
                    raise IndexError("index is empty")
                return np.zeros((0, self.cfg.dim), np.float32)
            if (ids < 0).any() or (ids >= self._n_inserted).any():
                raise IndexError(f"ids must be in [0, {self._n_inserted})")
            if self._dead and any(int(i) in self._dead for i in ids):
                raise IndexError("id was deleted")
            ext = np.asarray(self.state.ext_ids)
            live = ext >= 0
            inv = np.full(self._n_inserted, -1, np.int64)
            inv[ext[live]] = np.nonzero(live)[0]
            rows = inv[ids]
            vecs = np.asarray(
                jnp.take(self.state.vectors, jnp.asarray(rows), axis=0)
                .astype(jnp.float32)
            )
            if self.cfg.dtype == "int8":
                vecs = vecs * float(self.state.q_scale)
            return vecs

    # -- persistence (absent in the reference; SURVEY.md §5) ---------------
    def save(self, path: str) -> None:
        from ..io.persist import save_hnsw

        with self._lock:
            self._flush_locked()
            save_hnsw(path, self)

    @classmethod
    def load(cls, path: str) -> "HNSW":
        from ..io.persist import load_hnsw

        return load_hnsw(path)
