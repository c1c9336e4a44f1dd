"""Top-k primitives (smallest-score-first convention).

Replaces the reference's per-query candidate heap + insertion sort
(reference src/hnsw.zig:202-233) with dense batched top-k suitable for an accelerator.

Convention everywhere: scores are "smaller is better" surrogates
(see ops/distance.py); invalid entries carry +inf and ids carry -1.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

INF = jnp.inf


def smallest_k(scores: jax.Array, ids: jax.Array, k: int):
    """Per-row k smallest entries of (scores [..., C], ids [..., C]) -> ([..., k], [..., k]).

    Ties broken by position (stable enough for deterministic tests because inputs
    are generated deterministically). Invalid slots (+inf / id -1) sort last.
    """
    neg = -scores
    top_vals, top_idx = jax.lax.top_k(neg, k)
    out_ids = jnp.take_along_axis(ids, top_idx, axis=-1)
    out_scores = -top_vals
    # Entries that were +inf remain +inf; normalize their ids to -1.
    out_ids = jnp.where(jnp.isinf(out_scores), -1, out_ids)
    return out_scores, out_ids


def smallest_k_dense(scores: jax.Array, k: int):
    """k smallest over the last axis of a dense score matrix -> (scores, indices)."""
    top_vals, top_idx = jax.lax.top_k(-scores, k)
    return -top_vals, top_idx


def sort_smallest_k(scores: jax.Array, ids: jax.Array, k: int,
                    dedupe: bool = False):
    """Per-row k smallest via lax.sort — the fast path for WIDE batches.

    lax.top_k can degrade at huge-batch/narrow-row shapes where lax.sort
    stays flat, so the bulk-build merges sort instead (the comparison is not
    yet measured on the H100).

    Sorts by (score, id): deterministic, and exact duplicates (same id AND
    same score — e.g. a mutual edge arriving once as forward and once as
    reverse) become adjacent, so dedupe=True masks them with one O(C)
    neighbor compare plus a compacting second sort instead of an O(C^2)
    equality matrix. Invalid slots (+inf/-1) sort last.
    """
    idkey = jnp.where(ids < 0, jnp.int32(2**30), ids)
    if dedupe:
        # pass 1: group by id (score-ascending within a group), keep each
        # group's first occurrence — exact id-dedupe from one O(C) neighbor
        # compare. Catches same-id pairs even when their scores differ in the
        # last ulp (e.g. d(s,t) vs d(t,s) computed by different matmuls).
        sk, ss, si = jax.lax.sort((idkey, scores, ids), num_keys=2)
        dup = (sk[..., 1:] == sk[..., :-1]) & (si[..., 1:] >= 0)
        dup = jnp.concatenate([jnp.zeros_like(dup[..., :1]), dup], axis=-1)
        scores = jnp.where(dup, INF, ss)
        idkey = jnp.where(dup, jnp.int32(2**30), sk)
        ids = jnp.where(dup, -1, si)
    ss, _, si = jax.lax.sort((scores, idkey, ids), num_keys=2)
    out_s, out_i = ss[..., :k], si[..., :k]
    return jnp.where(out_i >= 0, out_s, INF), out_i


def bitonic_smallest_k(scores: jax.Array, ids: jax.Array, k: int):
    """Per-row k smallest via a bitonic sorting network — no lax.top_k.

    log^2(C) stages of static lane permutation + compare/select, all
    elementwise. Meant for WIDE batches of NARROW rows (C <= ~256) where
    top_k's per-call cost dominates — the reverse-edge merge, beam merges.
    Exact:
    full ascending sort of the padded row, then the first k columns.

    Ties break by smaller id (top_k breaks by position; callers that need
    exact top_k parity should sort inputs accordingly — engine results are
    id-deduped downstream so the distinction never reaches users).
    """
    import numpy as _np

    c = scores.shape[-1]
    cp = 1 << max(1, (max(c, k) - 1).bit_length())
    if cp > c:
        pad = [(0, 0)] * (scores.ndim - 1) + [(0, cp - c)]
        scores = jnp.pad(scores, pad, constant_values=INF)
        ids = jnp.pad(ids, pad, constant_values=-1)
    # invalid slots (+inf / id -1) must sort LAST regardless of id tie-break
    idkey = jnp.where(ids < 0, jnp.int32(2**30), ids)

    col = _np.arange(cp)
    size = 2
    while size <= cp:
        stride = size // 2
        while stride >= 1:
            partner = col ^ stride
            ascending = (col & size) == 0
            first = col < partner
            take_min = jnp.asarray(first == ascending)
            p_idx = jnp.asarray(partner)
            ps = jnp.take(scores, p_idx, axis=-1)
            pi = jnp.take(ids, p_idx, axis=-1)
            pk = jnp.take(idkey, p_idx, axis=-1)
            less = (scores < ps) | ((scores == ps) & (idkey < pk))
            keep_self = jnp.where(take_min, less, ~less)
            scores = jnp.where(keep_self, scores, ps)
            ids = jnp.where(keep_self, ids, pi)
            idkey = jnp.where(keep_self, idkey, pk)
            stride //= 2
        size *= 2
    out_s = scores[..., :k]
    out_i = ids[..., :k]
    return jnp.where(out_i >= 0, out_s, INF), out_i


def merge_topk(scores_a, ids_a, scores_b, ids_b, k: int):
    """Merge two per-row top-k lists into one top-k list (no dedupe)."""
    s = jnp.concatenate([scores_a, scores_b], axis=-1)
    i = jnp.concatenate([ids_a, ids_b], axis=-1)
    return smallest_k(s, i, k)


def mask_duplicate_ids(scores: jax.Array, ids: jax.Array):
    """Invalidate all but the first occurrence of each id per row.

    ids: [..., C] int32 (-1 = already invalid). Uses an O(C^2) equality matrix —
    C is small (beam widths), so this is VPU-cheap and shape-static.
    """
    eq = ids[..., :, None] == ids[..., None, :]  # [..., C, C]
    c = ids.shape[-1]
    earlier = jnp.tril(jnp.ones((c, c), bool), k=-1)
    dup = jnp.any(eq & earlier, axis=-1)  # True where an earlier slot has same id
    dup = dup & (ids >= 0)
    return jnp.where(dup, INF, scores), jnp.where(dup, -1, ids)


def mask_ids_in(scores: jax.Array, ids: jax.Array, banned: jax.Array):
    """Invalidate entries whose id appears in `banned` ([..., K] per-row id list)."""
    hit = jnp.any(ids[..., :, None] == banned[..., None, :], axis=-1)
    hit = hit & (ids >= 0)
    return jnp.where(hit, INF, scores), jnp.where(hit, -1, ids)


def bin_fold(s: jax.Array, l_bins: int, per_bin: int = 1):
    """Fold [..., n] scores (n a multiple of l_bins) into per-bin bests:
    column c belongs to bin c % l_bins, and each bin keeps its best
    (per_bin=1) or best two (per_bin=2) columns.

    Returns ([..., per_bin * L] scores, [..., per_bin * L] int32 columns):
    the first L hold each bin's best, the next L its runner-up. Ties keep
    the lower column; bins with no finite score give +inf / -1. Plain
    min/argmin reductions (no top_k), which XLA fuses."""
    g = s.shape[-1] // l_bins
    sr = s.reshape(*s.shape[:-1], g, l_bins)
    lane = jax.lax.broadcasted_iota(jnp.int32, sr.shape[:-2] + (l_bins,),
                                    sr.ndim - 2)
    outs_s, outs_c = [], []
    for _ in range(per_bin):
        best = jnp.min(sr, axis=-2)
        arg = jnp.argmin(sr, axis=-2).astype(jnp.int32)
        outs_s.append(best)
        outs_c.append(jnp.where(jnp.isfinite(best), arg * l_bins + lane, -1))
        grp = jax.lax.broadcasted_iota(jnp.int32, sr.shape, sr.ndim - 2)
        sr = jnp.where(grp == arg[..., None, :], INF, sr)
    return jnp.concatenate(outs_s, axis=-1), jnp.concatenate(outs_c, axis=-1)

