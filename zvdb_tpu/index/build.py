"""Bulk batched HNSW construction — lock-free by design.

Batched replacement for the reference's serialized per-insert mutation under a
global mutex (reference src/hnsw.zig:73-170). Construction here processes points
in batches; each batch:

  1. is ingested into the dense arrays (rows n..n+B-1),
  2. beam-searches the *frozen prefix* (rows < n) at every layer to collect
     ef_construction candidates per point per layer,
  3. unions in intra-batch brute-force kNN candidates (points in the same batch
     cannot see each other through the graph yet — SURVEY.md §7 "hard parts"),
  4. selects M neighbors per (point, layer) with a vectorized
     relative-neighborhood diversity rule (the selectNeighbors heuristic the
     reference lacks — it keeps plain nearest-m, src/hnsw.zig:143-170),
  5. inserts reverse edges with a sort-based scatter and re-prunes every touched
     row with the same diversity rule (replacing shrinkConnections).

Everything is static-shaped; scatter conflicts are resolved by sorting the edge
list by target and letting only each target's first occurrence write its
re-pruned row (all other writes land in the trash row cap+1).

Level sampling is canonical geometric with mL = 1/ln(m) from a JAX PRNG key
(the reference burns a CSPRNG coin-flip per level with p=0.5 —
src/hnsw.zig:172-180).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import distance as D
from ..ops import topk as T
from ..utils.config import HNSWConfig
from .hnsw import HNSWState, beam_layer, init_state, max_level_for

INF = jnp.inf
_BIG = jnp.float32(1e30)


def sample_levels(key: jax.Array, n: int, m: int, levels_cap: int, ml: Optional[float]) -> np.ndarray:
    """Geometric level sampling, level = floor(-ln(U) * mL), mL = 1/ln(m)."""
    mlv = ml if ml is not None else 1.0 / math.log(max(m, 2))
    u = jax.random.uniform(key, (n,), minval=1e-9, maxval=1.0)
    lv = jnp.floor(-jnp.log(u) * mlv).astype(jnp.int32)
    return np.asarray(jnp.clip(lv, 0, levels_cap))


# ---------------------------------------------------------------------------
# vectorized selectNeighbors (diversity pruning)


def select_neighbors(
    state: HNSWState,
    base_vec: jax.Array,     # [R, D] f32
    base_norm: jax.Array,    # [R] f32 (squared norms; zeros for dot/cosine)
    cand: jax.Array,         # [R, C] int32 candidate rows, -1 invalid, deduped
    cand_scores: jax.Array,  # [R, C] surrogate scores base->cand (inf invalid)
    m_out: int,
    alpha: float,
    metric: str,
    max_candidates: int = 0,
) -> jax.Array:
    """Pick up to m_out diverse neighbors per row.

    Returns (ids [R, m_out] (-1 pad), true_distances [R, m_out] (+inf pad)).

    Parallel relative-neighborhood rule: candidate c is pruned if some candidate
    e ranked strictly closer to the base satisfies alpha*d(c,e) < d(base,c).
    Pruned candidates backfill remaining slots in distance order (the
    keepPrunedConnections behavior of canonical HNSW). Fully vectorized: the
    pairwise candidate distances are one batched matmul.

    max_candidates > 0 first narrows the pool to the nearest C' candidates —
    the O(C^2 D) pairwise matmul dominates build time, and candidates far down
    the distance order are effectively never selected (they survive the RNG
    rule only to lose the priority sort, and backfill also prefers nearest).
    """
    if max_candidates and max_candidates < cand.shape[-1]:
        cand_scores, cand = T.smallest_k(cand_scores, cand, max_candidates)
    if cand.shape[-1] < m_out:   # tiny pools (e.g. top hierarchy layers)
        pad = m_out - cand.shape[-1]
        cand = jnp.pad(cand, ((0, 0), (0, pad)), constant_values=-1)
        cand_scores = jnp.pad(cand_scores, ((0, 0), (0, pad)), constant_values=INF)
    safe = jnp.maximum(cand, 0)
    c_vecs = jnp.take(state.vectors, safe, axis=0).astype(jnp.float32) \
        * state.q_scale  # [R, C, D] (dequantized; scale is 1.0 for float dtypes)
    c_norms = jnp.take(state.norms, safe, axis=0)                        # [R, C]
    valid = cand >= 0

    if metric == "l2":
        d_b = cand_scores + base_norm[:, None]  # true squared distance
    else:
        d_b = cand_scores
    d_b = jnp.where(valid, d_b, INF)

    dots = jnp.einsum(
        "rcd,red->rce", c_vecs, c_vecs, preferred_element_type=jnp.float32
    )
    if metric == "l2":
        d_cc = c_norms[:, :, None] + c_norms[:, None, :] - 2.0 * dots
    else:
        d_cc = -dots

    earlier = d_b[:, None, :] < d_b[:, :, None]          # [R, c, e]: e closer than c
    close = (alpha * d_cc) < d_b[:, :, None]             # e too close to c
    pruned = jnp.any(earlier & close & valid[:, None, :], axis=-1)

    keep = valid & ~pruned
    priority = jnp.where(keep, d_b, d_b + _BIG)
    priority = jnp.where(valid, priority, INF)
    _, pos = jax.lax.top_k(-priority, m_out)
    sel = jnp.take_along_axis(cand, pos, axis=-1)
    sel_d = jnp.take_along_axis(d_b, pos, axis=-1)
    sel = jnp.where(jnp.isfinite(sel_d), sel, -1)
    sel_d = jnp.where(sel >= 0, sel_d, INF)
    return sel, sel_d


# ---------------------------------------------------------------------------
# reverse-edge pass


def _reverse_pass(
    nbr_table: jax.Array,   # [cap+1, degree] adjacency for this layer
    dist_table: jax.Array,  # [cap+1, degree] true edge distances
    src_rows: jax.Array,    # [B] batch rows
    fwd: jax.Array,         # [B, m] forward-selected neighbors (-1 pad)
    fwd_d: jax.Array,       # [B, m] true distances of those edges
    degree: int,
):
    """Add reverse edges src->tgt for every forward edge tgt, keeping each
    touched target row's `degree` nearest edges.

    Entirely gather-free: edge distances are stored alongside the adjacency
    (d(src,tgt) of a reverse edge is the same value as the forward edge's), so
    the merge is pure scalar top-k — no vector rows are fetched. This is the
    batched answer to shrinkConnections (reference src/hnsw.zig:143-170,
    which recomputes distances per comparison): row gathers are the
    expensive operation, so the O(B*m) re-pruning must not touch vectors.

    Scatter-contention-free: edges sorted by target; each target's first
    occurrence computes and writes the merged row; all other occurrences write
    to the trash row (index cap). Returns (nbr_table, dist_table).
    """
    b, m = fwd.shape
    p = b * m
    cap_trash = nbr_table.shape[0] - 1
    rev_window = max(1, min(degree, 16, p))

    tgt = fwd.reshape(p)
    src = jnp.repeat(src_rows, m)
    d = fwd_d.reshape(p)
    valid = tgt >= 0
    key = jnp.where(valid, tgt, jnp.int32(2**30))
    # Deliberately sorted by target ONLY (stable, batch order within a run):
    # when a hub receives more than rev_window same-target edges, the window
    # keeps the first rev_window in batch order. A (target, distance) lexsort
    # that keeps the NEAREST sources instead was measured WORSE (-1.5pt
    # self-hit@ef48, 4k x 16d clustered, round 3): nearest reverse sources
    # are intra-cluster and cost edge diversity; arbitrary batch order keeps
    # more directions. The <= rev_window cap itself (16) is a documented
    # approximation for degree > 16 rows.
    order = jnp.argsort(key, stable=True)
    st = tgt[order]
    ss = src[order]
    sd = d[order]
    sv = valid[order]

    prev = jnp.concatenate([jnp.full((1,), -2, jnp.int32), st[:-1]])
    first = sv & (st != prev)

    # Window of up to rev_window sources per target. st[i+j] windows are
    # materialized as W SHIFTED CONTIGUOUS COPIES, not a [P, W] gather —
    # gathers are row-count-bound (~7 ns/row) and a [P, W] scalar gather is
    # P*W rows, which measured as the reverse pass's dominant cost at bulk
    # sizes (P = 2M); shifts are plain bandwidth.
    def shifted(a, j, fill):
        return jnp.concatenate([a[j:], jnp.full((j,), fill, a.dtype)]) if j \
            else a

    st_w = jnp.stack([shifted(st, j, jnp.int32(-9)) for j in range(rev_window)],
                     axis=1)                              # [P, W]
    ss_w = jnp.stack([shifted(ss, j, jnp.int32(-1)) for j in range(rev_window)],
                     axis=1)
    sd_w = jnp.stack([shifted(sd, j, jnp.float32(jnp.inf))
                      for j in range(rev_window)], axis=1)
    same = (st_w == st[:, None]) & sv[:, None]
    rev = jnp.where(same, ss_w, -1)                       # [P, W] new sources
    rev_d = jnp.where(same, sd_w, INF)

    st_safe = jnp.maximum(st, 0)
    existing = jnp.take(nbr_table, st_safe, axis=0)       # [P, degree]
    existing_d = jnp.take(dist_table, st_safe, axis=0)

    cand = jnp.concatenate([existing, rev], axis=-1)      # [P, degree + W]
    cand_d = jnp.concatenate([existing_d, rev_d], axis=-1)
    cand_d = jnp.where(cand >= 0, cand_d, INF)

    # Merge + exact id-dedupe in two lax.sort passes (ops/topk.py
    # sort_smallest_k): lax.top_k degrades at this huge-batch x narrow-row
    # [B*m, degree+W] shape, where lax.sort stays flat (see ops/topk.py).
    new_d, new_rows = T.sort_smallest_k(cand_d, cand, degree, dedupe=True)

    write_at = jnp.where(first, st, cap_trash)
    return (
        nbr_table.at[write_at].set(new_rows),
        dist_table.at[write_at].set(new_d),
    )


def _reverse_pass_bulk(
    nbr_table: jax.Array,   # [cap+1, degree] adjacency (forward edges set)
    dist_table: jax.Array,  # [cap+1, degree] true edge distances
    n_rows: int,            # static: forward edges come from rows [0, n)
    degree: int,
    rev_window: int = 0,    # 0 -> degree
):
    """Whole-graph reverse pass: one shot over every forward edge.

    The per-batch `_reverse_pass` computes a merged candidate row at EVERY
    one of P = n*degree edge positions and lets only each target's first
    occurrence write — at bulk sizes that is a degree-fold redundancy (the
    [P, W] shifted windows + [P, degree+W] merge sort dominated the round-2
    build at 0.8 s for 100k x degree 32). Here the merge happens once per
    TARGET row instead:

      1. sort the P (target, dist, src) triples by (target, dist) — one
         multi-operand lax.sort, no gathers;
      2. scatter each target's first position into a [cap] table;
      3. gather each target's nearest <= W reverse sources with a [cap, W]
         position gather (W*cap scalar rows, ~degree-fold fewer than [P, W]);
      4. merge + id-dedupe against the existing rows with one [cap, deg+W]
         sort_smallest_k and write back densely (no scatter).

    Window default matches the batched pass (min(degree, 16), batch order):
    wider windows feed the distance merge more nearest-source candidates and
    were measured to cost edge diversity (see _reverse_pass note).
    Returns (nbr_table, dist_table)."""
    cap1 = nbr_table.shape[0]
    w = rev_window if rev_window > 0 else max(1, min(degree, 16))
    fwd = nbr_table[:n_rows]
    fwd_d = dist_table[:n_rows]
    p = n_rows * degree

    tgt = fwd.reshape(p)
    src = jnp.broadcast_to(
        jnp.arange(n_rows, dtype=jnp.int32)[:, None], (n_rows, degree)
    ).reshape(p)
    d = fwd_d.reshape(p)
    valid = tgt >= 0
    key = jnp.where(valid, tgt, jnp.int32(2**30))
    # target-only STABLE sort: within a target's run, edges stay in row-major
    # (src, slot) order — same window membership as the batched pass; a
    # (target, distance) sort was measured worse (see _reverse_pass: nearest
    # reverse sources are intra-cluster and cost edge diversity)
    st, sd, ss = jax.lax.sort((key, jnp.where(valid, d, INF), src),
                              num_keys=1, is_stable=True)

    prev = jnp.concatenate([jnp.full((1,), -2, st.dtype), st[:-1]])
    first = (st != prev) & (st < jnp.int32(2**30))
    # first occurrence position of each target (p = "no reverse edges")
    pos0 = jnp.full((cap1,), p, jnp.int32).at[
        jnp.where(first, st, cap1 - 1)
    ].set(jnp.arange(p, dtype=jnp.int32), mode="drop")
    # the trash row may have been overwritten by a real first (target cap-1
    # is cap1-1... no: targets are < cap. Guard: recompute row cap1-1 as
    # no-op is fine because write below covers all rows identically.)

    idx = jnp.minimum(pos0[:, None] + jnp.arange(w, dtype=jnp.int32)[None, :],
                      p - 1)                                     # [cap1, W]
    has = pos0 < p
    rev_t = jnp.take(st, idx)                                    # [cap1, W]
    same = has[:, None] & (rev_t == jnp.arange(cap1, dtype=jnp.int32)[:, None])
    rev = jnp.where(same, jnp.take(ss, idx), -1)
    rev_d = jnp.where(same, jnp.take(sd, idx), INF)

    cand = jnp.concatenate([nbr_table, rev], axis=-1)            # [cap1, deg+W]
    cand_d = jnp.concatenate([dist_table, rev_d], axis=-1)
    cand_d = jnp.where(cand >= 0, cand_d, INF)
    new_d, new_rows = T.sort_smallest_k(cand_d, cand, degree, dedupe=True)
    # rows without reverse edges merge against all-invalid candidates: the
    # result is the row itself (distance-sorted) — safe to write densely
    return new_rows, new_d


_reverse_pass_bulk_jit = functools.partial(
    jax.jit, static_argnames=("n_rows", "degree", "rev_window"),
    donate_argnums=(0, 1),
)(_reverse_pass_bulk)


# ---------------------------------------------------------------------------
# one bulk-build batch step


def build_batch_impl(
    state: HNSWState,
    xb: jax.Array,
    lb: jax.Array,
    extb: jax.Array,
    valid: jax.Array,
    cfg: HNSWConfig,
    levels_cap: int,
) -> HNSWState:
    with D.precision_context(cfg.precision):
        return _build_batch_body(state, xb, lb, extb, valid, cfg, levels_cap)


def _build_batch_body(
    state: HNSWState,
    xb: jax.Array,        # [B, D] f32 batch vectors (raw)
    lb: jax.Array,        # [B] int32 batch levels (-1 for padding)
    extb: jax.Array,      # [B] int32 external ids
    valid: jax.Array,     # [B] bool
    cfg: HNSWConfig,
    levels_cap: int,
) -> HNSWState:
    b, d = xb.shape
    m, m0 = cfg.m, cfg.base_degree
    metric = cfg.metric
    prefix_n = state.n
    base = prefix_n  # batch rows occupy [base, base+B)
    rows = base + jnp.arange(b, dtype=jnp.int32)

    # ---- 1. ingest ------------------------------------------------------
    if cfg.dtype == "int8":
        stored, norms = D.quantize_corpus_global(xb, metric, state.q_scale)
    else:
        stored, norms = D.preprocess_corpus(xb, metric, cfg.storage_dtype)
    vectors = jax.lax.dynamic_update_slice(state.vectors, stored, (base, 0))
    vnorms = jax.lax.dynamic_update_slice(state.norms, norms, (base,))
    levels = jax.lax.dynamic_update_slice(
        state.levels, jnp.where(valid, lb, -1), (base,)
    )
    ext_ids = jax.lax.dynamic_update_slice(
        state.ext_ids, jnp.where(valid, extb, -1), (base,)
    )
    state = state._replace(vectors=vectors, norms=vnorms, levels=levels, ext_ids=ext_ids)

    # build queries = dequantized stored vectors (identical to stored for
    # float dtypes; for int8 this keeps build distances consistent with what
    # search will measure). cosine inputs are already normalized at ingest.
    q = stored.astype(jnp.float32) * state.q_scale
    qn = D.sq_norms(q)

    # ---- 2. frozen-prefix beams at every layer --------------------------
    ep = jnp.broadcast_to(state.entry, (b,))
    ep = jnp.where(ep < prefix_n, ep, -1)  # entry must be in the prefix
    ep_s = jnp.where(
        ep >= 0,
        D.gathered_scores(
            q,
            jnp.take(state.vectors, jnp.maximum(ep, 0), axis=0)[:, None, :],
            jnp.take(state.norms, jnp.maximum(ep, 0), axis=0)[:, None],
            metric, scale=state.q_scale,
        )[:, 0],
        INF,
    )

    layer_beams = {}
    if cfg.upper_beam:
        # canonical: ef-beam at every layer (one while_loop per layer)
        seed_r, seed_s = ep[:, None], ep_s[:, None]
        for ell in range(levels_cap, 0, -1):
            bs, br = beam_layer(
                state, q, seed_r, seed_s, state.nbrU[ell - 1],
                ef=cfg.ef_construction_upper, metric=metric,
                expand=cfg.build_expand, limit_n=prefix_n,
            )
            layer_beams[ell] = (bs, br)
            better = bs[:, :1] < seed_s[:, :1]
            seed_r = jnp.where(better & (br[:, :1] >= 0), br[:, :1], seed_r)
            seed_s = jnp.where(better, bs[:, :1], seed_s)
        bs0, br0 = beam_layer(
            state, q, seed_r, seed_s, state.nbr0,
            ef=cfg.ef_construction, metric=metric, expand=cfg.build_expand,
            limit_n=prefix_n,
        )
        layer_beams[0] = (bs0, br0)
    else:
        # fast path: greedy descent through upper layers (recording the local
        # minimum per layer), one ef_construction beam at the base layer only.
        # Upper-layer edge candidates are level-filtered base candidates — upper
        # layers only route searches, so this trades negligible routing quality
        # for an L-fold reduction in build while_loops.
        from .hnsw import _greedy_layer

        seed_r, seed_s = ep, ep_s
        path = {}
        for ell in range(levels_cap, 0, -1):
            seed_r, seed_s = _greedy_layer(
                state, q, seed_r, seed_s, state.nbrU[ell - 1], metric, 32
            )
            path[ell] = (seed_s, seed_r)
        bs0, br0 = beam_layer(
            state, q, seed_r[:, None], seed_s[:, None], state.nbr0,
            ef=cfg.ef_construction, metric=metric, expand=cfg.build_expand,
            limit_n=prefix_n,
        )
        layer_beams[0] = (bs0, br0)
        cand_lv = jnp.take(state.levels, jnp.maximum(br0, 0))
        for ell in range(1, levels_cap + 1):
            ok = (br0 >= 0) & (cand_lv >= ell)
            g_s = jnp.where(ok, bs0, INF)
            g_r = jnp.where(ok, br0, -1)
            ps, pr = path[ell]
            # the greedy-path node is a valid layer-l candidate only if it
            # actually reaches layer l (the entry seed may sit lower)
            p_ok = (pr >= 0) & (jnp.take(state.levels, jnp.maximum(pr, 0)) >= ell)
            ps = jnp.where(p_ok, ps, INF)
            pr = jnp.where(p_ok, pr, -1)
            layer_beams[ell] = (
                jnp.concatenate([ps[:, None], g_s], axis=-1),
                jnp.concatenate([pr[:, None], g_r], axis=-1),
            )

    # ---- 3. intra-batch brute-force candidates --------------------------
    intra = D.pairwise_scores(q, q, jnp.where(valid, qn, INF), metric)  # [B, B]
    eye = jnp.eye(b, dtype=bool)
    intra = jnp.where(eye | ~valid[None, :], INF, intra)

    def layer_edges(ell, degree, k_intra):
        """Forward selection for one layer: returns (fwd ids, fwd dists, padded
        row blocks). Shared by the unconditional base layer and the
        cond-wrapped upper layers."""
        active = valid & (lb >= ell)
        # intra candidates restricted to batch points that reach this layer.
        # Width matches the construction beam so first-batch inserts (whose
        # only candidates are intra-batch) see as rich a pool as searched ones.
        intra_l = jnp.where(active[None, :], intra, INF)
        i_s, i_c = T.smallest_k_dense(intra_l, k_intra)
        i_rows = jnp.where(jnp.isfinite(i_s), base + i_c.astype(jnp.int32), -1)
        i_s = jnp.where(i_rows >= 0, i_s, INF)

        g_s, g_r = layer_beams[ell]
        c_s = jnp.concatenate([g_s, i_s], axis=-1)
        c_r = jnp.concatenate([g_r, i_rows], axis=-1)
        c_s, c_r = T.mask_duplicate_ids(c_s, c_r)

        fwd, fwd_d = select_neighbors(
            state, q, qn, c_r, c_s, m, cfg.alpha, metric,
            max_candidates=cfg.select_cap,
        )
        fwd = jnp.where(active[:, None], fwd, -1)
        fwd_d = jnp.where(fwd >= 0, fwd_d, INF)
        pad_w = degree - m
        if pad_w > 0:
            row_ids = jnp.concatenate(
                [fwd, jnp.full((b, pad_w), -1, jnp.int32)], axis=-1
            )
            row_ds = jnp.concatenate(
                [fwd_d, jnp.full((b, pad_w), INF, jnp.float32)], axis=-1
            )
        else:
            row_ids, row_ds = fwd[:, :degree], fwd_d[:, :degree]
        return fwd, fwd_d, row_ids, row_ds

    # ---- base layer: forward edges + reverse merge (always) --------------
    fwd0, fwd0_d, row_ids, row_ds = layer_edges(
        0, m0, min(b, cfg.ef_construction)
    )
    nbr0_t = jax.lax.dynamic_update_slice(state.nbr0, row_ids, (base, 0))
    dist0_t = jax.lax.dynamic_update_slice(state.dist0, row_ds, (base, 0))
    nbr0_t, dist0_t = _reverse_pass(nbr0_t, dist0_t, rows, fwd0, fwd0_d, m0)
    state = state._replace(nbr0=nbr0_t, dist0=dist0_t)

    # ---- upper layers: cond-skipped when no batch point reaches them -----
    # (with level-sorted bulk build, all upper-layer work concentrates in the
    # first batches; the ~300-470 ms/layer select+reverse fusions then no-op at
    # runtime for every later batch — measured 66% of steady-state batch time)
    nbrU_t, distU_t = state.nbrU, state.distU
    k_intra_u = min(b, cfg.ef_construction_upper)
    for ell in range(1, levels_cap + 1):
        def work(ops, ell=ell):
            tab, dtab = ops
            fwd, fwd_d, row_ids, row_ds = layer_edges(ell, m, k_intra_u)
            tab = jax.lax.dynamic_update_slice(tab, row_ids, (base, 0))
            dtab = jax.lax.dynamic_update_slice(dtab, row_ds, (base, 0))
            return _reverse_pass(tab, dtab, rows, fwd, fwd_d, m)

        any_here = jnp.any(valid & (lb >= ell))
        tab, dtab = jax.lax.cond(
            any_here, work, lambda ops: ops,
            (nbrU_t[ell - 1], distU_t[ell - 1]),
        )
        nbrU_t = nbrU_t.at[ell - 1].set(tab)
        distU_t = distU_t.at[ell - 1].set(dtab)
    state = state._replace(nbrU=nbrU_t, distU=distU_t)

    # ---- 5. bookkeeping -------------------------------------------------
    lb_masked = jnp.where(valid, lb, -1)
    batch_max = jnp.max(lb_masked)
    batch_best = base + jnp.argmax(lb_masked).astype(jnp.int32)
    promote = (state.entry < 0) | (batch_max > state.max_level)
    has_any = jnp.any(valid)
    entry = jnp.where(promote & has_any, batch_best, state.entry)
    max_level = jnp.maximum(state.max_level, jnp.where(has_any, batch_max, 0))
    n = state.n + jnp.sum(valid).astype(jnp.int32)
    return state._replace(entry=entry, max_level=max_level, n=n)


build_batch_step = functools.partial(
    jax.jit,
    static_argnames=("cfg", "levels_cap"),
    donate_argnums=(0,),
)(build_batch_impl)


# ---------------------------------------------------------------------------
# orchestration


def reorder_rows_diverse(state: HNSWState, cfg: HNSWConfig) -> HNSWState:
    """Reorder every base-layer adjacency row diversity-first.

    Rows end up nearest-first after the reverse-edge merges, so truncated-degree
    search (SearchConfig.search_degree) reads only intra-cluster edges and
    recall collapses (measured 0.95 -> 0.32 at degree 16). This one-shot pass
    re-runs the RNG diversity rule per row and stores kept (diverse) edges
    first, making truncation read a degree-d diverse subgraph. O(N * M0^2 * D)
    in matmuls + one N*M0-row gather.
    """
    cap = state.vectors.shape[0]
    tile = 8192

    @functools.partial(jax.jit, static_argnames=("t",))
    def fix_tile(state, lo, t):
        rows = lo + jnp.arange(t, dtype=jnp.int32)
        nbr = jax.lax.dynamic_slice(state.nbr0, (lo, 0), (t, state.nbr0.shape[1]))
        dst = jax.lax.dynamic_slice(state.dist0, (lo, 0), (t, state.dist0.shape[1]))
        base_vec = jnp.take(state.vectors, rows, axis=0).astype(jnp.float32) \
            * state.q_scale
        base_norm = jnp.take(state.norms, rows, axis=0)
        # select_neighbors wants surrogate scores; stored dists are true metric
        scores = dst - (base_norm[:, None] if cfg.metric == "l2" else 0.0)
        with D.precision_context(
            cfg.precision if cfg.precision != "default" else "high"
        ):
            new_ids, new_d = select_neighbors(
                state, base_vec, base_norm, nbr, scores,
                state.nbr0.shape[1], cfg.alpha, cfg.metric,
            )
        live = jnp.take(state.levels, rows) >= 0
        new_ids = jnp.where(live[:, None], new_ids, nbr)
        new_d = jnp.where(live[:, None], new_d, dst)
        return state._replace(
            nbr0=jax.lax.dynamic_update_slice(state.nbr0, new_ids, (lo, 0)),
            dist0=jax.lax.dynamic_update_slice(state.dist0, new_d, (lo, 0)),
        )

    for lo in range(0, cap, tile):
        t = min(tile, cap - lo)
        state = fix_tile(state, jnp.asarray(lo, jnp.int32), t)
    return state


def _run_batches(state, x, levels, ext, cfg, levels_cap,
                 start_batch: int = 0, on_batch=None):
    n = x.shape[0]
    bsz = min(cfg.build_batch, max(n, 1))
    nb = -(-n // bsz)
    for t in range(start_batch, nb):
        lo, hi = t * bsz, min((t + 1) * bsz, n)
        xb = np.zeros((bsz, cfg.dim), np.float32)
        xb[: hi - lo] = x[lo:hi]
        lb = np.full((bsz,), -1, np.int32)
        lb[: hi - lo] = levels[lo:hi]
        eb = np.full((bsz,), -1, np.int32)
        eb[: hi - lo] = ext[lo:hi]
        vb = np.zeros((bsz,), bool)
        vb[: hi - lo] = True
        state = build_batch_step(
            state, jnp.asarray(xb), jnp.asarray(lb), jnp.asarray(eb),
            jnp.asarray(vb), cfg, levels_cap,
        )
        if on_batch is not None:
            state = on_batch(state, t, nb) or state
    return state


def save_build_checkpoint(path: str, state: HNSWState, x, levels, ext,
                          cfg: HNSWConfig, levels_cap: int, next_batch: int,
                          capacity: int) -> None:
    """Snapshot a partially-built graph + remaining work for crash recovery
    (SURVEY.md §5: the reference has no checkpoint/resume at all; expensive
    bulk builds at DEEP-10M scale need it)."""
    import dataclasses
    import json

    arrays = {f: np.asarray(getattr(state, f)) for f in HNSWState._fields}
    meta = dict(cfg=dataclasses.asdict(cfg), levels_cap=levels_cap,
                next_batch=next_batch, capacity=capacity)
    np.savez_compressed(path, meta=json.dumps(meta), corpus=x, lv=levels,
                        ext=ext, **arrays)


def resume_build(path: str):
    """Continue a checkpointed bulk build. Returns (state, capacity, levels_cap)."""
    import json

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        cfg = HNSWConfig(**meta["cfg"])
        state = HNSWState(**{
            f: jnp.asarray(z[f]) for f in HNSWState._fields
        })
        x = z["corpus"]
        levels = z["lv"]
        ext = z["ext"]
    state = _run_batches(state, x, levels, ext, cfg, meta["levels_cap"],
                         start_batch=meta["next_batch"])
    # same epilogue as bulk_build: anchors (acceleration structure — a fresh
    # key is fine, the graph is unaffected) and the diversity row reorder
    # (deterministic function of the state; required for resumed == direct
    # graph equality when cfg.diverse_rows)
    state = _attach_anchors(state, x.shape[0], jax.random.PRNGKey(0))
    if cfg.diverse_rows:
        state = reorder_rows_diverse(state, cfg)
    return state, meta["capacity"], meta["levels_cap"], cfg


def _subset_knn_layer(
    xj: jax.Array,          # [N, D] f32 dequantized corpus
    xn: jax.Array,          # [N] f32
    rows: np.ndarray,       # subset rows (nodes reaching this layer)
    degree: int,
    alpha: float,
    metric: str,
    key: jax.Array,
) -> Tuple[jax.Array, jax.Array]:
    """Navigable graph over a subset (one upper HNSW layer).

    Uses the full cluster-kNN builder (reverse edges + random long-range
    links) rather than plain exact kNN: upper layers exist to ROUTE greedy
    descent, and an exact kNN graph over clustered data has no long edges —
    measured on micro-clustered corpora, exact-kNN upper layers strand the
    descent in a far micro-cluster and cap full-search recall at ~0.63 where
    the same base graph reaches 0.98 when seeded well. Returns
    (nbrs [S, degree] int32 GLOBAL row ids, dists [S, degree])."""
    from .knn_graph import build_knn_graph

    s = rows.shape[0]
    rows_j = jnp.asarray(rows, jnp.int32)
    sub_x = jnp.take(xj, rows_j, axis=0)
    # device array passes straight through (np.asarray here would be a
    # device->host pull + re-upload per layer)
    nbrs_l, dists_l, *_ = build_knn_graph(
        sub_x, degree, key, metric=metric, alpha=max(alpha, 1.1),
    )
    local = nbrs_l[:s]
    glob = jnp.where(local >= 0, jnp.take(rows_j, jnp.maximum(local, 0)), -1)
    return glob, dists_l[:s]


def bulk_build_oneshot(
    x: np.ndarray,
    cfg: HNSWConfig,
    key: jax.Array,
    capacity: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
) -> Tuple[HNSWState, int, int]:
    """One-shot bulk HNSW construction from dense matmuls — no beam loops.

    The base layer is the cluster-kNN graph (knn_graph.build_knn_graph:
    spilled k-means blocks -> per-block brute force -> diversity prune ->
    reverse edges). Upper layers are small (geometric level sampling), so each
    is an exact-or-recursive kNN graph over its node subset. This replaces the
    batched frozen-prefix beam build (most of its time in the beam
    while_loop) with pure matmul work; graph quality is equal or better
    (candidates come from several clusterings instead of one beam's view).
    Search-time behavior (hierarchy descent, ef beam) is unchanged.

    checkpoint_path: snapshot the build once the base-layer graph (the
    dominant cost) is done; resume_build_oneshot(path) reruns only the
    cheap upper-layer/anchor/reorder epilogue. The epilogue replays the same
    PRNG splits from the saved key, so resumed == direct build.
    """
    return _oneshot_impl(x, cfg, key, capacity, checkpoint_path, resume=None)


def resume_build_oneshot(path: str) -> Tuple[HNSWState, int, int, HNSWConfig]:
    """Finish a crashed oneshot build from its base-layer checkpoint."""
    import json

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("kind") != "hnsw_oneshot":
            raise ValueError(f"not a oneshot build checkpoint: {path}")
        cfg = HNSWConfig(**meta["cfg"])
        state, cap, levels_cap = _oneshot_impl(
            z["corpus"], cfg, jnp.asarray(z["key"]), meta["capacity"], None,
            resume=(z["lv"], z["nbrs"], z["dists"]),
        )
    return state, cap, levels_cap, cfg


def _oneshot_impl(x, cfg, key, capacity, checkpoint_path, resume):
    from .knn_graph import build_knn_graph

    n = x.shape[0]
    bsz = min(cfg.build_batch, max(n, 1))
    cap_min = -(-max(n, 1) // bsz) * bsz
    cap = max(capacity, cap_min) if capacity is not None else cap_min
    levels_cap = cfg.max_level if cfg.max_level is not None else max_level_for(cap, cfg.m)
    state = init_state(cap, cfg, levels_cap)
    if n == 0:
        return state, cap, levels_cap

    # DEVICE-RESIDENT corpora stay on device (np.asarray on a jax array would
    # pull it to the host only to re-upload it one line later); host
    # corpora take the numpy path unchanged.
    on_device = isinstance(x, jax.Array)
    if on_device:
        xs = x.astype(jnp.float32)
        if cfg.metric == "cosine":
            xs = xs / jnp.maximum(
                jnp.linalg.norm(xs, axis=1, keepdims=True), 1e-12)
        if cfg.dtype == "int8":
            amax = float(jnp.abs(xs).max()) if n else 1.0
            state = state._replace(
                q_scale=jnp.asarray(max(amax, 1e-12) / 127.0, jnp.float32)
            )
    else:
        xs = np.asarray(x, np.float32)
        if cfg.metric == "cosine":
            # idempotent, so re-running it on a resumed (already normalized)
            # corpus is safe
            xs = xs / np.maximum(
                np.linalg.norm(xs, axis=1, keepdims=True), 1e-12)
        if cfg.dtype == "int8":
            amax = float(np.abs(xs).max()) if n else 1.0
            state = state._replace(
                q_scale=jnp.asarray(max(amax, 1e-12) / 127.0, jnp.float32)
            )

    prec = cfg.precision if cfg.precision != "default" else "high"
    key0 = key   # saved in the checkpoint; resume replays the same splits
    key, k_lv, k_base = jax.random.split(key, 3)
    levels = resume[0] if resume is not None else \
        sample_levels(k_lv, n, cfg.m, levels_cap, cfg.ml)

    # ---- ingest ---------------------------------------------------------
    xj_in = jnp.asarray(xs)
    if cfg.dtype == "int8":
        stored, norms = D.quantize_corpus_global(xj_in, cfg.metric, state.q_scale)
    else:
        stored, norms = D.preprocess_corpus(xj_in, cfg.metric, cfg.storage_dtype)
    state = state._replace(
        vectors=state.vectors.at[:n].set(stored),
        norms=state.norms.at[:n].set(norms),
        levels=state.levels.at[:n].set(jnp.asarray(levels)),
        ext_ids=state.ext_ids.at[:n].set(jnp.arange(n, dtype=jnp.int32)),
    )
    # the graph is built over what the index will actually search: the
    # (dequantized) stored vectors
    xj = stored.astype(jnp.float32) * state.q_scale
    xn = D.sq_norms(xj) if cfg.metric == "l2" else jnp.zeros((n,), jnp.float32)

    # ---- base layer -------------------------------------------------------
    if resume is not None:
        nbrs_n, dists_n = jnp.asarray(resume[1]), jnp.asarray(resume[2])
    else:
        # pass the DEVICE array (dequantized stored vectors): build_knn_graph
        # would otherwise re-upload the corpus
        nbrs, dists, *_ = build_knn_graph(
            xj, cfg.base_degree, k_base, metric=cfg.metric,
            alpha=cfg.alpha, precision=prec,
            kc_per_view=cfg.kc_per_view, prune_cap=cfg.prune_cap,
            block_topk=cfg.block_topk, kmeans_iters=cfg.build_kmeans_iters,
        )
        nbrs_n, dists_n = nbrs[:n], dists[:n]
    state = state._replace(
        nbr0=state.nbr0.at[:n].set(nbrs_n),
        dist0=state.dist0.at[:n].set(dists_n),
    )
    if checkpoint_path and resume is None:
        import dataclasses
        import json

        np.savez_compressed(
            checkpoint_path,
            meta=json.dumps(dict(kind="hnsw_oneshot",
                                 cfg=dataclasses.asdict(cfg), capacity=cap)),
            corpus=xs, lv=np.asarray(levels), key=np.asarray(key0),
            nbrs=np.asarray(nbrs_n), dists=np.asarray(dists_n),
        )

    # ---- upper layers -----------------------------------------------------
    with D.precision_context(prec):
        for ell in range(1, levels_cap + 1):
            rows = np.nonzero(np.asarray(levels) >= ell)[0]
            if rows.size < 2:
                break
            key, sub = jax.random.split(key)
            glob, gd = _subset_knn_layer(
                xj, xn, rows, cfg.m, cfg.alpha, cfg.metric, sub
            )
            rows_j = jnp.asarray(rows, jnp.int32)
            state = state._replace(
                nbrU=state.nbrU.at[ell - 1, rows_j].set(glob),
                distU=state.distU.at[ell - 1, rows_j].set(gd),
            )

    levels = np.asarray(levels)
    entry = int(np.argmax(levels))
    state = state._replace(
        entry=jnp.asarray(entry, jnp.int32),
        max_level=jnp.asarray(int(levels.max()), jnp.int32),
        n=jnp.asarray(n, jnp.int32),
    )
    key, k_anchor = jax.random.split(key)
    state = _attach_anchors(state, n, k_anchor)
    if cfg.diverse_rows:
        state = reorder_rows_diverse(state, cfg)
    return state, cap, levels_cap


def _attach_anchors(state: HNSWState, n: int, key: jax.Array) -> HNSWState:
    """Sample ~n/12 rows as a dense anchor seed table (see HNSWState.anchors)."""
    if n <= 0:
        return state
    a = 1 << max(10, min(15, int(math.ceil(math.log2(max(n, 2) / 12.0)))))
    if a >= n:
        rows = jnp.arange(n, dtype=jnp.int32)
    else:
        rows = jax.random.choice(key, n, (a,), replace=False).astype(jnp.int32)
    vecs = jnp.take(state.vectors, rows, axis=0).astype(jnp.float32) * state.q_scale
    norms = jnp.take(state.norms, rows)
    return state._replace(anchors=vecs, a_norms=norms, a_rows=rows)


def bulk_build(
    x: np.ndarray,
    cfg: HNSWConfig,
    key: jax.Array,
    sort_by_level: bool = True,
    capacity: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
) -> Tuple[HNSWState, int, int]:
    """Build a fresh index over corpus x [N, D]. Returns (state, capacity, levels_cap).

    Points are inserted in level-descending order so the frozen prefix always
    contains every node of equal-or-higher level (the entry point is therefore
    correct from the first batch — unlike the reference, which pins the entry to
    node 0 forever, src/hnsw.zig:110-112).
    """
    n = x.shape[0]
    # Capacity is rounded up to a whole number of build batches: every batch
    # writes a full [B] row block, and dynamic_update_slice CLAMPS out-of-bounds
    # starts (a partial final batch would silently shift and corrupt rows).
    bsz = min(cfg.build_batch, max(n, 1))
    cap_min = -(-max(n, 1) // bsz) * bsz
    cap = max(capacity, cap_min) if capacity is not None else cap_min
    levels_cap = cfg.max_level if cfg.max_level is not None else max_level_for(cap, cfg.m)
    state = init_state(cap, cfg, levels_cap)
    if cfg.dtype == "int8":
        # per-tensor scale from the whole corpus (for cosine: post-normalization
        # magnitudes are <= 1); later extend_graph batches clip to this scale
        xs_for_scale = np.asarray(x, np.float32)
        if cfg.metric == "cosine" and n:
            xs_for_scale = xs_for_scale / np.maximum(
                np.linalg.norm(xs_for_scale, axis=1, keepdims=True), 1e-12
            )
        amax = float(np.abs(xs_for_scale).max()) if n else 1.0
        state = state._replace(
            q_scale=jnp.asarray(max(amax, 1e-12) / 127.0, jnp.float32)
        )
    if n == 0:
        return state, cap, levels_cap
    levels = sample_levels(key, n, cfg.m, levels_cap, cfg.ml)
    order = np.argsort(-levels, kind="stable") if sort_by_level else np.arange(n)
    xs = np.asarray(x, np.float32)[order]
    ls = levels[order]
    ext = order.astype(np.int32)
    on_batch = None
    if checkpoint_path and checkpoint_every > 0:
        def on_batch(st, t, nb):
            if (t + 1) % checkpoint_every == 0 and t + 1 < nb:
                save_build_checkpoint(checkpoint_path, st, xs, ls, ext, cfg,
                                      levels_cap, t + 1, cap)
            return st
    state = _run_batches(state, xs, ls, ext, cfg, levels_cap, on_batch=on_batch)
    key, k_anchor = jax.random.split(key)
    state = _attach_anchors(state, n, k_anchor)
    if cfg.diverse_rows:
        state = reorder_rows_diverse(state, cfg)
    return state, cap, levels_cap


def extend_graph(
    state: Optional[HNSWState],
    capacity: int,
    levels_cap: int,
    x: np.ndarray,
    cfg: HNSWConfig,
    key: jax.Array,
    ext_id_start: int,
) -> Tuple[HNSWState, int]:
    """Append a batch of points to an existing graph (incremental insert path).

    Arrival order is preserved; the entry point is promoted if a new node's level
    exceeds the current max (fidelity-ledger fix)."""
    n_new = x.shape[0]
    if state is None:
        st, cap, _ = bulk_build(
            x, cfg, key, sort_by_level=True,
            capacity=max(n_new, 1024),
        )
        # bulk_build assigned ext ids 0..n-1 by original position; shift them
        st = st._replace(
            ext_ids=jnp.where(st.ext_ids >= 0, st.ext_ids + ext_id_start, -1)
        )
        return st, cap
    # Reserve a full batch-aligned window past n: batch writes are [B] blocks
    # starting at n, and dynamic_update_slice clamps OOB starts (see bulk_build).
    bsz = min(cfg.build_batch, max(n_new, 1))
    nb = -(-n_new // bsz)
    need = int(state.n) + nb * bsz
    if need > capacity:
        new_cap = max(need, 2 * capacity)
        grown = init_state(new_cap, cfg, levels_cap)
        state = HNSWState(
            vectors=grown.vectors.at[:capacity].set(state.vectors),
            norms=grown.norms.at[:capacity].set(state.norms),
            nbr0=grown.nbr0.at[:capacity].set(state.nbr0[:-1]),
            nbrU=grown.nbrU.at[:, :capacity].set(state.nbrU[:, :-1]),
            dist0=grown.dist0.at[:capacity].set(state.dist0[:-1]),
            distU=grown.distU.at[:, :capacity].set(state.distU[:, :-1]),
            levels=grown.levels.at[:capacity].set(state.levels),
            ext_ids=grown.ext_ids.at[:capacity].set(state.ext_ids),
            entry=state.entry,
            max_level=state.max_level,
            n=state.n,
            q_scale=state.q_scale,
            anchors=state.anchors,
            a_norms=state.a_norms,
            a_rows=state.a_rows,
        )
        capacity = new_cap
    levels = sample_levels(key, n_new, cfg.m, levels_cap, cfg.ml)
    ext = np.arange(ext_id_start, ext_id_start + n_new, dtype=np.int32)
    state = _run_batches(state, np.asarray(x, np.float32), levels, ext, cfg, levels_cap)
    return state, capacity
