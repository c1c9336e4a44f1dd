"""All-matmul approximate kNN-graph construction via spilled clustering.

This is the batched answer to incremental graph construction (reference
src/hnsw.zig:73-170 builds its graph one point at a time under a global
mutex; a batched beam-search build is still while_loop-bound). Here the
whole graph materializes from dense matmuls:

  1. k-means the corpus into C clusters of ~`block` points (matmul, sampled).
  2. Assign every point to its `spill` nearest clusters (one [N, C] matmul).
  3. Pack clusters into contiguous blocks; compute each block's FULL pairwise
     distance matrix with one batched einsum and take the top-k per row
     — every point gets candidate neighbors from `spill` overlapping blocks.
  4. Repeat for `passes` independent clusterings (different k-means seeds give
     different boundaries; the union repairs boundary-loss).
  5. Merge + dedupe per point, diversity-prune (relative-neighborhood rule)
     to `degree`, then add reverse edges with per-row re-pruning.

No beam searches, no data-dependent while_loops: the only non-matmul costs
are the pack/scatter and the pruning gathers. Graph quality matches or beats
the sequential build (boundary candidates come from TWO views of the corpus;
reverse edges restore asymmetric misses).
"""
from __future__ import annotations

import functools
import math
import os
import time
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import distance as D
from ..ops import topk as T
from ..utils.config import BLOCK_TOPK_MODES

INF = jnp.inf


class VecStore(NamedTuple):
    """Duck-typed stand-in for HNSWState in select_neighbors (vectors/norms/
    q_scale are the only fields it reads)."""
    vectors: jax.Array
    norms: jax.Array
    q_scale: jax.Array


# ---------------------------------------------------------------------------
# device-resident k-means (no host round-trips: re-uploading corpus samples
# per pass would dominate small builds)


def _kmeans_device(xj: jax.Array, c: int, iters: int, key: jax.Array,
                   sample: int = 65536) -> jax.Array:
    from .ivf import _assign, _update_centroids  # jitted matmul Lloyd pieces

    n = xj.shape[0]
    k1, k2 = jax.random.split(key)
    if n > sample:
        sel = jax.random.choice(k1, n, (sample,), replace=False)
        xs = jnp.take(xj, sel, axis=0)
    else:
        xs = xj
    m = xs.shape[0]
    init_sel = jax.random.choice(k2, m, (c,), replace=m < c)
    cent = jnp.take(xs, init_sel, axis=0)
    xn = D.sq_norms(xs)
    for _ in range(iters):
        a = _assign(xs, xn, cent, D.sq_norms(cent))
        cent = _update_centroids(xs, a, cent)
    return cent


# ---------------------------------------------------------------------------
# assignment + packing


@functools.partial(jax.jit, static_argnames=("spill", "metric", "tile"))
def _assign_spill(x, xn, cent, cn, spill: int, metric: str, tile: int = 16384):
    """Per point: its `spill` nearest clusters and the rank-0 score.
    Returns (assign [N, spill] int32, best_score [N] f32)."""
    n = x.shape[0]
    pad = -(-n // tile) * tile - n
    xp = jnp.pad(x, ((0, pad), (0, 0)))
    xt = xp.reshape(-1, tile, x.shape[1])

    def body(_, xt_i):
        s = D.pairwise_scores(xt_i, cent, cn, metric)
        neg, idx = jax.lax.top_k(-s, spill)
        return None, (idx.astype(jnp.int32), -neg[:, 0])

    _, (a, s0) = jax.lax.scan(body, None, xt)
    return a.reshape(-1, spill)[:n], s0.reshape(-1)[:n]


def _pack_blocks(assign: np.ndarray, c: int, bcap: int):
    """Pack (point, rank) pairs into per-cluster blocks, rank-0 first.

    When a cluster overflows `bcap`, the dropped pairs are its highest-rank
    (least valuable) spill assignments. Returns (block_pts [C, bcap] int32
    -1-padded, block_occ [C, bcap] int32 spill-rank of each slot, n_dropped).
    """
    n, spill = assign.shape
    cluster = assign.reshape(-1)
    rank = np.tile(np.arange(spill, dtype=np.int64), n)
    point = np.repeat(np.arange(n, dtype=np.int64), spill)
    order = np.lexsort((rank, cluster))
    sc, sr, sp = cluster[order], rank[order], point[order]
    first = np.searchsorted(sc, np.arange(c), side="left")
    pos_in_cluster = np.arange(n * spill) - first[sc]
    keep = pos_in_cluster < bcap
    block_pts = np.full((c, bcap), -1, np.int32)
    block_occ = np.zeros((c, bcap), np.int32)
    block_pts[sc[keep], pos_in_cluster[keep]] = sp[keep].astype(np.int32)
    block_occ[sc[keep], pos_in_cluster[keep]] = sr[keep].astype(np.int32)

    # Guarantee presence: a point dropped from EVERY block (its rank-0 cluster
    # overflowed too) would end up with no candidates at all — isolated and
    # unreachable. Pack all absent points, grouped by their rank-0 cluster so
    # blockmates are near each other, into dedicated overflow blocks.
    present = np.zeros(n, bool)
    live = block_pts[block_pts >= 0]
    present[live] = True
    missing = np.nonzero(~present)[0]
    if missing.size:
        order = np.argsort(assign[missing, 0], kind="stable")
        mm = missing[order].astype(np.int32)
        rows = -(-mm.size // bcap)
        extra = np.full((rows, bcap), -1, np.int32)
        extra.reshape(-1)[: mm.size] = mm
        block_pts = np.concatenate([block_pts, extra], axis=0)
        block_occ = np.concatenate(
            [block_occ, np.zeros((rows, bcap), np.int32)], axis=0
        )
    return block_pts, block_occ, int((~keep).sum())


@functools.partial(jax.jit, static_argnames=("c", "bcap", "spill"))
def _pack_core(assign, c: int, bcap: int, spill: int):
    """Device-side _pack_blocks: same (point, rank) -> per-cluster block
    tables, built from one lax.sort instead of a host lexsort + scatter.

    The host pack is seconds of single-core numpy at 1M x spill 2 (and the
    packed tables then re-upload); on device the tables never leave device
    memory. Returns (block_pts [c, bcap],
    block_occ [c, bcap], n_missing scalar, morder [n] int32) where morder
    orders points by (present, rank-0 cluster) so the first n_missing entries
    are exactly the host pack's presence-overflow set in its order.
    """
    n, sp_w = assign.shape
    cluster = assign.reshape(-1).astype(jnp.int32)
    rank = jnp.tile(jnp.arange(sp_w, dtype=jnp.int32), (n,))
    point = jnp.repeat(jnp.arange(n, dtype=jnp.int32), sp_w)
    # composite key reproduces lexsort((rank, cluster)); c*spill stays far
    # below 2^31 for any corpus this engine packs
    order = jnp.argsort(cluster * sp_w + rank)
    sc = jnp.take(cluster, order)
    sr = jnp.take(rank, order)
    sp = jnp.take(point, order)
    first = jnp.searchsorted(sc, jnp.arange(c, dtype=jnp.int32), side="left")
    pos = jnp.arange(n * sp_w, dtype=jnp.int32) - jnp.take(first, sc)
    keep = pos < bcap
    wp = jnp.where(keep, sc, c)                      # row c = trash
    wpos = jnp.clip(pos, 0, bcap - 1)
    block_pts = jnp.full((c + 1, bcap), -1, jnp.int32) \
        .at[wp, wpos].set(jnp.where(keep, sp, -1))
    block_occ = jnp.zeros((c + 1, bcap), jnp.int32) \
        .at[wp, wpos].set(jnp.where(keep, sr, 0))
    present = jnp.zeros((n + 1,), bool) \
        .at[jnp.where(keep, sp, n)].set(True)[:n]
    n_missing = jnp.sum(~present).astype(jnp.int32)
    # absent points first, grouped by their rank-0 cluster (stable lexsort
    # == the host pack's kind="stable" ordering; int32-safe — no x64 dep)
    morder = jnp.lexsort((assign[:, 0], present)).astype(jnp.int32)
    return block_pts[:c], block_occ[:c], n_missing, morder


@functools.partial(jax.jit, static_argnames=("c", "reps"))
def _reps_chain_device(assign0, s0, c: int, reps: int):
    """Device-side representative rows + cluster chain (see the host block in
    _build_steps for the rationale). Returns (c_rows [c, reps] int32,
    chain [n] int32 successor-or--1)."""
    n = assign0.shape[0]
    order = jnp.lexsort((s0, assign0)).astype(jnp.int32)
    sa0 = jnp.take(assign0, order)
    cl = jnp.arange(c, dtype=sa0.dtype)
    starts = jnp.searchsorted(sa0, cl, side="left").astype(jnp.int32)
    ends = jnp.searchsorted(sa0, cl, side="right").astype(jnp.int32)
    span = jnp.maximum(ends - starts, 1)
    has = ends > starts
    cols = []
    for r in range(reps):
        frac = r / max(reps, 1)
        pos = starts + jnp.minimum((frac * span).astype(jnp.int32),
                                   jnp.maximum(ends - starts - 1, 0))
        pos = jnp.clip(pos, 0, n - 1)
        cols.append(jnp.where(has, jnp.take(order, pos), 0))
    c_rows = jnp.stack(cols, axis=1)
    idx = jnp.arange(n, dtype=jnp.int32)
    pos_next = idx + 1
    is_last = pos_next >= jnp.take(ends, sa0)
    pos_next = jnp.where(is_last, jnp.take(starts, sa0), pos_next)
    chain = jnp.zeros((n,), jnp.int32).at[order].set(
        jnp.take(order, pos_next))
    chain = jnp.where(chain == idx, -1, chain)       # singleton clusters
    return c_rows, chain


# ---------------------------------------------------------------------------
# per-block brute-force kNN + candidate scatter


@functools.partial(jax.jit, static_argnames=("kc", "metric", "sel"),
                   donate_argnums=(5, 6))
def _block_knn_scatter(
    x, xn, block_pts, block_occ, occ_base, cand_s, cand_i, kc: int, metric: str,
    sel: str = "exact",
):
    """One chunk of clusters: dense intra-block distance matrix -> top-kc per
    row -> scatter each slot's candidate list into its point's occurrence lane.

    cand_s/cand_i: [N+1, O, kc] accumulation buffers (row N = trash).
    occ_base: scalar int32, this pass's first occurrence lane (pass * spill).
    sel: per-row selection — "exact" (full top_k), "approx" (hardware
    approx_min_k), "binfold" (modular bins folded with a pure-VPU min, then
    one cheap two-sort top-kc over the L bin minima; candidate GENERATION
    only — per-view bin collisions are absorbed by the multi-view union +
    prune + reverse downstream, same argument as "approx").
    """
    cc, bcap = block_pts.shape
    safe = jnp.maximum(block_pts, 0)
    v = jnp.take(x, safe, axis=0)                      # [cc, B, D]
    vn = jnp.take(xn, safe, axis=0)                    # [cc, B]
    valid = block_pts >= 0
    dots = jnp.einsum("cbd,ced->cbe", v, v, preferred_element_type=jnp.float32)
    # Validity rides the NEIGHBOR norm column (+inf -> score +inf) and
    # self-pairs are the diagonal only (_pack_blocks never places a point
    # twice in one block: spill assignments are distinct clusters, overflow
    # rows hold otherwise-absent points). The previous 3-compare mask
    # materialized [cc, B, B] bools — several extra full passes over the
    # score tensor that measured as most of the selection overhead.
    # Invalid SOURCE rows score garbage but scatter to the trash row below.
    nbias = jnp.where(valid, vn if metric == "l2" else 0.0, INF)   # [cc, B]
    if metric == "l2":
        s = nbias[:, None, :] - 2.0 * dots
    else:
        s = nbias[:, None, :] - dots
    eye = jax.lax.broadcasted_iota(jnp.int32, (bcap, bcap), 0) == \
        jax.lax.broadcasted_iota(jnp.int32, (bcap, bcap), 1)
    s = jnp.where(eye[None], INF, s)
    kk = min(kc, bcap)
    if sel == "binfold" and bcap >= 4 * kk:
        L = min(bcap, max(4 * kk, 32))
        padb = -(-bcap // L) * L - bcap
        sp = jnp.pad(s, ((0, 0), (0, 0), (0, padb)), constant_values=INF)
        sr = sp.reshape(cc, bcap, -1, L)               # [cc, B, G, L]
        bin_s = sr.min(axis=2)                         # [cc, B, L]
        bin_g = sr.argmin(axis=2).astype(jnp.int32)
        col = bin_g * L + jax.lax.broadcasted_iota(jnp.int32, bin_s.shape, 2)
        ts, tp = T.sort_smallest_k(
            bin_s.reshape(cc * bcap, L), col.reshape(cc * bcap, L), kk)
        ts = ts.reshape(cc, bcap, kk)
        tp = jnp.minimum(jnp.maximum(tp.reshape(cc, bcap, kk), 0), bcap - 1)
    elif sel == "approx" and bcap >= 4 * kk:
        # hardware partial top-k: candidate GENERATION only — the per-view
        # unions + diversity prune + reverse pass downstream absorb the few
        # percent of per-view misses (measured: end recall unchanged)
        ts, tp = jax.lax.approx_min_k(s, kk)
    else:
        neg, tp = jax.lax.top_k(-s, kk)                # [cc, B, kk]
        ts = -neg
    tids = jnp.take_along_axis(
        jnp.broadcast_to(block_pts[:, None, :], s.shape[:2] + (bcap,)), tp,
        axis=-1,
    )
    tids = jnp.where(jnp.isfinite(ts), tids, -1)
    if kk < kc:
        ts = jnp.pad(ts, ((0, 0), (0, 0), (0, kc - kk)), constant_values=INF)
        tids = jnp.pad(tids, ((0, 0), (0, 0), (0, kc - kk)), constant_values=-1)

    npts = cand_s.shape[0] - 1
    wp = jnp.where(valid, block_pts, npts).reshape(-1)      # invalid -> trash row
    wo = (occ_base + block_occ).reshape(-1)
    cand_s = cand_s.at[wp, wo].set(ts.reshape(-1, kc))
    cand_i = cand_i.at[wp, wo].set(tids.reshape(-1, kc))
    return cand_s, cand_i


# ---------------------------------------------------------------------------
# merge + diversity prune + reverse edges


@functools.partial(jax.jit, static_argnames=("degree", "metric", "prune_cap"))
def _prune_chunk(x, xn, rows, cand_s, cand_i, alpha, degree: int, metric: str,
                 prune_cap: int = 0):
    """Dedupe one chunk's merged candidates and diversity-prune to `degree`.
    Returns (sel [T, degree] int32, sel_d [T, degree] true distances).
    prune_cap > 0 narrows the merged pool to the nearest prune_cap before the
    O(C^2 D) pairwise matmul (the build's dominant FLOP term)."""
    from .build import select_neighbors  # local import avoids a cycle

    cs, ci = T.mask_duplicate_ids(cand_s, cand_i)
    store = VecStore(x, xn, jnp.asarray(1.0, jnp.float32))
    base_vec = jnp.take(x, rows, axis=0)
    base_norm = jnp.take(xn, rows, axis=0)
    return select_neighbors(store, base_vec, base_norm, ci, cs, degree,
                            alpha, metric, max_candidates=prune_cap)


def build_knn_graph(
    x,  # np.ndarray or device array [N, D] (device arrays are not re-uploaded)
    degree: int,
    key: jax.Array,
    metric: str = "l2",
    block: int = 1024,
    spill: int = 2,
    passes: int = 2,
    kmeans_iters: int = 5,
    alpha: float = 1.2,
    reverse: bool = True,
    balance_slack: float = 1.6,
    precision: str = "high",
    prune_chunk: int = 8192,
    reverse_chunk: int = 131072,
    reps: int = 4,
    n_long: int = 4,
    kc_per_view: int = 0,
    prune_cap: int = 0,
    block_topk: str = "exact",
    chain: bool = True,
    kmeans_sample: int = 65536,
    segments=None,
    pack: str = "device",
) -> Tuple[np.ndarray, jax.Array, jax.Array, jax.Array, jax.Array]:
    """Build a `degree`-regular approximate kNN graph over x [N, D].

    segments: optional list of device arrays replacing x (upload-overlap
    path — see _build_steps).

    Returns (nbrs [N+1, degree] int32 -1-padded (row N is the scatter trash
    row), dists [N+1, degree] f32 true distances, centroids [C, D] f32 of the
    LAST clustering pass, c_norms [C], c_rows [C, reps] int32 representative
    rows per cluster) — the centroid set doubles as the search-time seed
    structure. Representatives are spread across each cluster's
    distance-to-centroid order, not just the medoid: a k-means cluster that
    straddles two natural subclusters would otherwise seed searches only into
    the medoid's subcluster (measured: ~30% of self-queries landed in the
    wrong component with medoid-only seeding).

    `n_long` random long-range edges are stamped into each row's tail AFTER
    the reverse pass (NSW-style expander links; a pure kNN graph on clustered
    data is disconnected by construction, and distance-pruned reverse merges
    would evict far edges). They are one-directional by design.

    x must already be metric-preprocessed (cosine: normalized). All distances
    are surrogate-consistent: squared-L2 for l2, -dot for dot/cosine.
    """
    ctx = D.precision_context(precision)
    gen = _build_steps(
        x, degree, key, metric=metric, block=block, spill=spill, passes=passes,
        kmeans_iters=kmeans_iters, alpha=alpha, reverse=reverse,
        balance_slack=balance_slack, prune_chunk=prune_chunk,
        reverse_chunk=reverse_chunk, reps=reps, n_long=n_long,
        kc_per_view=kc_per_view, prune_cap=prune_cap, block_topk=block_topk,
        chain=chain, kmeans_sample=kmeans_sample, segments=segments, pack=pack,
    )
    with ctx:
        try:
            req = next(gen)
            while True:
                req = gen.send(tuple(np.asarray(a) for a in req))
        except StopIteration as e:
            return e.value


def build_knn_graph_multi(
    xs,  # list of per-shard corpora (np or device arrays)
    degree: int,
    keys,  # list of PRNG keys, one per shard
    devices=None,  # optional list of jax devices, one per shard
    precision: str = "high",
    **kw,
):
    """Phase-interleaved multi-shard graph build.

    Drives one _build_steps generator per shard, advancing ALL shards through
    each device phase before pulling any shard's host-sync arrays: every
    shard's k-means/assignment/block-kNN work is dispatched (on its own
    device when `devices` is given) before the host blocks on the first
    pull, so device phases overlap across shards and the host bookkeeping of
    shard i overlaps the device work of the others. On a real multi-chip mesh
    this makes the bulk build ~S-way parallel; on the single-core CI host the
    virtual CPU devices share one core and the orchestration is throughput-
    neutral (docs/PERF.md "sharded build" note).

    Returns a list of per-shard (nbrs, dists, centroids, c_norms, c_rows).
    """
    ctx = D.precision_context(precision)
    s = len(xs)
    devices = devices if devices is not None else [None] * s
    results: list = [None] * s
    with ctx:
        gens = []
        for x, key, dev in zip(xs, keys, devices):
            xj = jnp.asarray(x, jnp.float32)
            if dev is not None:
                xj = jax.device_put(xj, dev)
            gens.append(_build_steps(xj, degree, key, **kw))
        # advance every generator to its next sync point, then satisfy the
        # pulls in order (while the host blocks on shard 0's pull, the other
        # shards' dispatched work proceeds)
        pending = [(i, None) for i in range(s)]
        while pending:
            reqs = []
            for i, send_val in pending:
                try:
                    req = next(gens[i]) if send_val is None \
                        else gens[i].send(send_val)
                    reqs.append((i, req))
                except StopIteration as e:
                    results[i] = e.value
            pending = [
                (i, tuple(np.asarray(a) for a in req)) for i, req in reqs
            ]
    return results


def _build_steps(
    x,
    degree: int,
    key: jax.Array,
    metric: str = "l2",
    block: int = 1024,
    spill: int = 2,
    passes: int = 2,
    kmeans_iters: int = 5,
    alpha: float = 1.2,
    reverse: bool = True,
    balance_slack: float = 1.6,
    prune_chunk: int = 8192,
    reverse_chunk: int = 131072,
    reps: int = 4,
    n_long: int = 4,
    kc_per_view: int = 0,
    prune_cap: int = 0,
    block_topk: str = "exact",
    chain: bool = True,
    kmeans_sample: int = 65536,
    segments=None,
    pack: str = "device",
):
    """Generator form of the graph build: yields tuples of device arrays at
    each host-sync point and expects the pulled numpy values back via send().
    Matmul precision context is the DRIVER's responsibility (a `with` block
    suspended across yields would leak into interleaved shards).

    segments: optional list of device arrays whose concatenation is the
    corpus — the UPLOAD-OVERLAP path. Host->device transfer can run on the
    copy engine concurrently with compute, but only if no
    queued program consumes the still-in-flight buffers: pass-0 k-means runs
    on segment 0 alone and per-segment assignment consumes each segment as
    it lands, so clustering hides under the transfer of the later segments;
    the full-corpus concat is dispatched AFTER those (stream is in-order —
    dispatching it earlier would stall compute on the whole transfer).
    Pass-0's k-means sample is segment-0-biased; pass 1 samples the full
    corpus, and the multi-view union absorbs the difference (recall pinned
    by the bench)."""
    from .build import _reverse_pass  # local import avoids a cycle

    if block_topk not in BLOCK_TOPK_MODES:
        raise ValueError(
            f"block_topk must be one of {BLOCK_TOPK_MODES}, got {block_topk!r}")
    trace = os.environ.get("ZVDB_BUILD_TRACE", "") not in ("", "0")
    marks = [("start", time.perf_counter())]

    def mark(name, *sync):
        if trace:
            if sync:
                jax.block_until_ready(sync)
            marks.append((name, time.perf_counter()))

    if segments is not None:
        n = sum(int(s.shape[0]) for s in segments)
        d = int(segments[0].shape[1])
        xj = xn = None   # materialized after pass-0 assignment dispatches
        if n <= max(degree + 1, 32):
            xj = jnp.concatenate(
                [s.astype(jnp.float32) for s in segments], axis=0)
            xn = D.sq_norms(xj) if metric == "l2" \
                else jnp.zeros((n,), jnp.float32)
            return _tiny_graph(xj, xn, n, degree, metric)
    else:
        n, d = x.shape
        xj = jnp.asarray(x, jnp.float32)
        xn = D.sq_norms(xj) if metric == "l2" else jnp.zeros((n,), jnp.float32)
        if n <= max(degree + 1, 32):
            return _tiny_graph(xj, xn, n, degree, metric)

    if True:
        block = int(min(block, max(64, n)))
        kc = min(kc_per_view if kc_per_view > 0 else degree, block - 1)
        o_total = passes * spill
        cand_s = jnp.full((n + 1, o_total, kc), INF, jnp.float32)
        cand_i = jnp.full((n + 1, o_total, kc), -1, jnp.int32)

        centroids = c_norms = c_rows = None
        for p in range(passes):
            key, sub = jax.random.split(key)
            c = max(1, int(round(n * spill / block)))
            if p == 0 and segments is not None:
                seg0 = segments[0].astype(jnp.float32)
                centj = _kmeans_device(
                    seg0, c, kmeans_iters, sub,
                    sample=min(int(seg0.shape[0]), kmeans_sample))
                mark("p0:kmeans")   # no sync: would stall the overlap
                cn = D.sq_norms(centj) if metric == "l2" \
                    else jnp.zeros((c,), jnp.float32)
                per_seg = []
                for seg in segments:
                    seg_f = seg.astype(jnp.float32)
                    seg_n = D.sq_norms(seg_f) if metric == "l2" \
                        else jnp.zeros((seg_f.shape[0],), jnp.float32)
                    a_i, s_i = _assign_spill(seg_f, seg_n, centj, cn,
                                             min(spill, c), metric)
                    per_seg.extend((a_i, s_i))
                # full corpus materializes only after the per-segment work
                # is queued (in-order stream: see docstring)
                xj = jnp.concatenate(
                    [s.astype(jnp.float32) for s in segments], axis=0)
                xn = D.sq_norms(xj) if metric == "l2" \
                    else jnp.zeros((n,), jnp.float32)
                if pack == "device":
                    assign = jnp.concatenate(per_seg[0::2], axis=0)
                    s0 = jnp.concatenate(per_seg[1::2], axis=0)
                    assign_np = s0n = None
                else:
                    pulled = yield tuple(per_seg)
                    assign_np = np.concatenate(pulled[0::2], axis=0)
                    s0n = np.concatenate(pulled[1::2], axis=0)
            else:
                centj = _kmeans_device(xj, c, kmeans_iters, sub,
                                       sample=min(n, kmeans_sample))
                mark(f"p{p}:kmeans", centj)
                cn = D.sq_norms(centj) if metric == "l2" else jnp.zeros((c,), jnp.float32)
                assign, s0 = _assign_spill(xj, xn, centj, cn, min(spill, c), metric)
                if pack == "device":
                    assign_np = s0n = None
                else:
                    # host-sync point: the pack below needs the assignment on
                    # the host. Yield so a multi-shard driver can dispatch
                    # other shards' device work before blocking on this pull.
                    assign_np, s0n = yield (assign, s0)
            mark(f"p{p}:assign+pull")
            bcap = max(8, int(math.ceil(balance_slack * spill * n / c / 8.0)) * 8)
            bcap = min(bcap, n * spill)
            if pack == "device":
                # assignment/sort/scatter stay in HBM; the only host syncs are
                # the n_missing scalar (and, rarely, the overflow order pull)
                if assign.shape[1] < spill:   # c < spill: replicate
                    assign = jnp.pad(
                        assign, ((0, 0), (0, spill - assign.shape[1])),
                        mode="edge")
                bp_j, bo_j, nmiss, morder = _pack_core(assign, c, bcap, spill)
                (nm_np,) = yield (nmiss,)
                nm = int(nm_np)
                if nm > 0:
                    # presence-overflow blocks: tiny, host-shaped (row count is
                    # data-dependent — a device-side version would recompile
                    # per distinct count through the remote compile service)
                    (morder_np,) = yield (morder,)
                    mm = morder_np[:nm].astype(np.int32)
                    rows = -(-nm // bcap)
                    extra = np.full((rows, bcap), -1, np.int32)
                    extra.reshape(-1)[: nm] = mm
                    bp_j = jnp.concatenate([bp_j, jnp.asarray(extra)], axis=0)
                    bo_j = jnp.concatenate(
                        [bo_j, jnp.zeros((rows, bcap), jnp.int32)], axis=0)
                mark(f"p{p}:host-pack")
                c_blocks = bp_j.shape[0]
                cc = max(1, (1 << 25) // max(bcap * bcap, 1))
                pad_rows = (-c_blocks) % cc
                if pad_rows:
                    bp_j = jnp.pad(bp_j, ((0, pad_rows), (0, 0)),
                                   constant_values=-1)
                    bo_j = jnp.pad(bo_j, ((0, pad_rows), (0, 0)))
                for lo in range(0, c_blocks, cc):
                    cand_s, cand_i = _block_knn_scatter(
                        xj, xn,
                        jax.lax.dynamic_slice_in_dim(bp_j, lo, cc, 0),
                        jax.lax.dynamic_slice_in_dim(bo_j, lo, cc, 0),
                        jnp.asarray(p * spill, jnp.int32), cand_s, cand_i,
                        kc, metric, sel=block_topk,
                    )
                del bp_j, bo_j
            else:
                if assign_np.shape[1] < spill:   # c < spill: replicate
                    assign_np = np.pad(
                        assign_np,
                        ((0, 0), (0, spill - assign_np.shape[1])),
                        mode="edge")
                block_pts, block_occ, _dropped = _pack_blocks(assign_np, c, bcap)
                mark(f"p{p}:host-pack")

                # chunk clusters so the [cc, B, B] score tensor stays ~128 MB
                c_blocks = block_pts.shape[0]  # incl. presence-overflow blocks
                cc = max(1, (1 << 25) // max(bcap * bcap, 1))
                for lo in range(0, c_blocks, cc):
                    hi = min(lo + cc, c_blocks)
                    bp = np.full((cc, bcap), -1, np.int32)
                    bo = np.zeros((cc, bcap), np.int32)
                    bp[: hi - lo] = block_pts[lo:hi]
                    bo[: hi - lo] = block_occ[lo:hi]
                    cand_s, cand_i = _block_knn_scatter(
                        xj, xn, jnp.asarray(bp), jnp.asarray(bo),
                        jnp.asarray(p * spill, jnp.int32), cand_s, cand_i,
                        kc, metric, sel=block_topk,
                    )
            mark(f"p{p}:block-knn", cand_s)

            if p == passes - 1:
                centroids, c_norms = centj, cn
                # `reps` representative rows per cluster, spread evenly along
                # the cluster's distance-to-centroid order (slot 0 = medoid).
                # Evenly spaced distance bands tend to hit different natural
                # subclusters when the k-means cluster straddles several.
                # Chain successor: each point -> the next point of its
                # cluster in distance-to-centroid order (wrapping). Stamped
                # as a guaranteed edge after the reverse pass: on
                # duplicate-heavy data, distance-pruned rows collapse into
                # ~degree-sized cliques and the clique's non-core members
                # end up with NO incoming edges (measured: 5% of self-queries
                # unreachable at any ef). The chain gives every point an
                # in-edge from a cluster-mate, so reaching ANY point of a
                # cluster makes the whole cluster reachable.
                if pack == "device":
                    c_rows, chain_np = _reps_chain_device(
                        assign[:, 0], s0, c, reps)
                else:
                    a0 = assign_np[:, 0]
                    # s0n was pulled alongside the assignment at the yield
                    order = np.lexsort((s0n, a0))
                    sa0 = a0[order]
                    starts = np.searchsorted(sa0, np.arange(c), side="left")
                    ends = np.searchsorted(sa0, np.arange(c), side="right")
                    c_rows_np = np.zeros((c, reps), np.int32)
                    for r in range(reps):
                        frac = r / max(reps, 1)
                        pos = starts + np.minimum(
                            (frac * np.maximum(ends - starts, 1))
                            .astype(np.int64),
                            np.maximum(ends - starts - 1, 0),
                        )
                        pos = np.clip(pos, 0, n - 1)
                        has = ends > starts
                        c_rows_np[:, r] = np.where(has, order[pos], 0)
                    c_rows = jnp.asarray(c_rows_np)
                    idx_n = np.arange(n)
                    pos_next = idx_n + 1
                    is_last = pos_next >= ends[sa0]
                    pos_next = np.where(is_last, starts[sa0], pos_next)
                    chain_np = np.full(n, -1, np.int64)
                    chain_np[order] = order[pos_next]
                    chain_np[chain_np == idx_n] = -1   # singleton clusters
                mark("reps")

        # ---- merge + prune ------------------------------------------------
        # occurrence lanes flattened; row n is the scatter trash row. Chunks
        # are padded to a fixed width so every iteration reuses one program
        # (padding rows index the trash row n and their output is dropped by
        # the update slice staying in-bounds: chunk starts are clamped).
        cand_s = cand_s.reshape(n + 1, o_total * kc)
        cand_i = cand_i.reshape(n + 1, o_total * kc)
        nbrs = jnp.full((n + 1, degree), -1, jnp.int32)
        dists = jnp.full((n + 1, degree), INF, jnp.float32)
        alpha_j = jnp.asarray(alpha, jnp.float32)
        pc = min(prune_chunk, n)
        for lo in range(0, n, pc):
            lo = min(lo, n - pc)   # final chunk re-covers the tail
            rows = jnp.arange(lo, lo + pc, dtype=jnp.int32)
            cs = jax.lax.dynamic_slice(cand_s, (lo, 0), (pc, cand_s.shape[1]))
            ci = jax.lax.dynamic_slice(cand_i, (lo, 0), (pc, cand_i.shape[1]))
            sel, sel_d = _prune_chunk(xj, xn, rows, cs, ci, alpha_j, degree,
                                      metric, prune_cap=prune_cap)
            nbrs = jax.lax.dynamic_update_slice(nbrs, sel, (lo, 0))
            dists = jax.lax.dynamic_update_slice(dists, sel_d, (lo, 0))
        mark("prune", nbrs)

        # ---- reverse edges --------------------------------------------------
        if reverse:
            if n * degree <= (1 << 25) and not os.environ.get("ZVDB_OLD_REVERSE"):
                # one-shot per-TARGET formulation: ~degree-fold less work
                # than the per-edge-position batched pass (round-2's 0.8 s
                # reverse at 100k x deg 32). Edge-list memory is O(n*degree),
                # so gate on P <= 32M edges and fall back to chunking above
                # that (10M-scale graphs).
                from .build import _reverse_pass_bulk_jit

                nbrs, dists = _reverse_pass_bulk_jit(
                    nbrs, dists, n_rows=n, degree=degree)
            else:
                rev_fn = jax.jit(
                    functools.partial(_reverse_pass, degree=degree),
                )
                rc = min(reverse_chunk, n)
                for lo in range(0, n, rc):
                    lo = min(lo, n - rc)   # final chunk re-covers the tail
                    rows = jnp.arange(lo, lo + rc, dtype=jnp.int32)
                    fwd = jax.lax.dynamic_slice(nbrs, (lo, 0), (rc, degree))
                    fwd_d = jax.lax.dynamic_slice(dists, (lo, 0), (rc, degree))
                    nbrs, dists = rev_fn(nbrs, dists, rows, fwd, fwd_d)
            mark("reverse", nbrs)

        # ---- chain edges (see above; slot before the long-range block) ------
        if chain and n > degree + 1 and degree - n_long >= 2:
            nbrs, dists = _stamp_chain_edges(
                xj, xn, nbrs, dists, jnp.asarray(chain_np, dtype=jnp.int32),
                metric, slot=degree - n_long - 1,
            )
            mark("chain", nbrs)

        # ---- random long-range edges (post-reverse: distance-pruned merges
        # would evict them) ---------------------------------------------------
        if n_long > 0 and n > degree + 1:
            key, sub = jax.random.split(key)
            nbrs, dists = _stamp_long_edges(xj, xn, nbrs, dists, sub,
                                            n_long, metric)
        mark("long-edges", nbrs)

    if trace:
        total = marks[-1][1] - marks[0][1]
        parts = "  ".join(
            f"{name}={t1 - t0:.2f}s"
            for (_, t0), (name, t1) in zip(marks, marks[1:])
        )
        print(f"[build_knn_graph n={n}] total={total:.2f}s  {parts}",
              flush=True)
    return nbrs, dists, centroids, c_norms, c_rows


@functools.partial(jax.jit, static_argnames=("metric", "slot"),
                   donate_argnums=(2, 3))
def _stamp_chain_edges(xj, xn, nbrs, dists, succ, metric: str, slot: int):
    """Overwrite one slot of each row with the cluster-chain edge."""
    valid = succ >= 0
    safe = jnp.maximum(succ, 0)
    v = jnp.take(xj, safe, axis=0)
    dots = jnp.sum(xj * v, axis=-1)
    if metric == "l2":
        d = xn + jnp.take(xn, safe) - 2.0 * dots
    else:
        d = -dots
    new_id = jnp.where(valid, succ, nbrs[:-1, slot])
    new_d = jnp.where(valid, d, dists[:-1, slot])
    return (nbrs.at[:-1, slot].set(new_id),
            dists.at[:-1, slot].set(new_d))


@functools.partial(jax.jit, static_argnames=("n_long", "metric"),
                   donate_argnums=(2, 3))
def _stamp_long_edges(xj, xn, nbrs, dists, key, n_long: int, metric: str):
    """Overwrite each row's last n_long slots with random long-range edges."""
    n = xj.shape[0]
    degree = nbrs.shape[1]
    ids = jax.random.randint(key, (n, n_long), 0, n, jnp.int32)
    rows = jnp.arange(n, dtype=jnp.int32)[:, None]
    ids = jnp.where(ids == rows, (ids + 1) % n, ids)
    v = jnp.take(xj, ids, axis=0)                       # [N, L, D]
    dots = jnp.einsum("nd,nld->nl", xj, v, preferred_element_type=jnp.float32)
    if metric == "l2":
        d = xn[:, None] + jnp.take(xn, ids, axis=0) - 2.0 * dots
    else:
        d = -dots
    # row N (trash) keeps its padding
    ids_full = jnp.concatenate([ids, jnp.full((1, n_long), -1, jnp.int32)])
    d_full = jnp.concatenate([d, jnp.full((1, n_long), jnp.inf, jnp.float32)])
    nbrs = nbrs.at[:, degree - n_long:].set(ids_full)
    dists = dists.at[:, degree - n_long:].set(d_full)
    return nbrs, dists


def _tiny_graph(xj, xn, n, degree, metric):
    """n <= degree+1ish: exact dense graph, single matmul."""
    s = D.pairwise_scores(xj, xj, xn, metric)
    s = jnp.where(jnp.eye(n, dtype=bool), INF, s)
    kk = min(degree, max(n - 1, 1))
    neg, idx = jax.lax.top_k(-s, kk)
    ts = -neg
    if metric == "l2":
        ts = ts + xn[:, None]
    ids = jnp.where(jnp.isfinite(ts), idx.astype(jnp.int32), -1)
    ts = jnp.where(ids >= 0, ts, INF)
    if kk < degree:
        ids = jnp.pad(ids, ((0, 0), (0, degree - kk)), constant_values=-1)
        ts = jnp.pad(ts, ((0, 0), (0, degree - kk)), constant_values=np.inf)
    nbrs = jnp.concatenate([ids, jnp.full((1, degree), -1, jnp.int32)])
    dists = jnp.concatenate([ts, jnp.full((1, degree), np.inf, jnp.float32)])
    cent = jnp.mean(xj, axis=0, keepdims=True)
    cn = D.sq_norms(cent) if metric == "l2" else jnp.zeros((1,), jnp.float32)
    return nbrs, dists, cent, cn, jnp.zeros((1, 1), jnp.int32)
