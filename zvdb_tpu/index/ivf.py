"""IVF-Flat index: cluster-blocked inverted file.

Motivation: random row gathers are the expensive operation of graph
traversal (random 512B rows), far below the device's memory bandwidth.
This layout instead groups the corpus into k-means clusters stored as
CONTIGUOUS blocks; search becomes

    q x centroids matmul  ->  top-nprobe clusters per query
    -> per probe: one big block gather (B rows of ~100KB: byte-bound, full
       bandwidth) + dense batched scoring + running top-k merge (lax.scan)

No random row gathers anywhere. The HNSW index (index/hnsw.py) remains the
reference-parity capability.

k-means runs on-device: assignment is a tiled [N, C] matmul argmin; the
centroid update is the one-hot-matmul trick (onehot^T @ x) so Lloyd iterations
are pure matmul work. Cluster blocks are balanced host-side by spilling overflow
points to their next-nearest cluster (bounds block padding waste).
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

INF = jnp.inf


@dataclasses.dataclass(frozen=True)
class IVFConfig:
    dim: int
    n_clusters: Optional[int] = None      # default: ~4*sqrt(N), pow2-rounded
    nprobe: int = 16
    metric: str = "l2"
    dtype: str = "float32"                # block storage dtype
    kmeans_iters: int = 12
    kmeans_sample: int = 131072           # max points used for Lloyd iterations
    # block capacity = factor * (N / C), rounded up to a multiple of 8
    max_cluster_factor: float = 2.0
    precision: str = "float32"
    # Exact rerank: merge rerank*k candidates from the (possibly quantized)
    # scan, rescore them against full-precision shadow vectors, return top-k.
    # 0 = off. Essential for int8 blocks (quantization noise otherwise caps
    # recall); costs one small row-gather (B * rerank*k rows).
    rerank: int = 0
    rerank_dtype: str = "float32"  # bf16 shadows rescore WORSE than residual-int8 on concentrated data (measured)
    # Block capacity packed after k-means splitting = headroom * the largest
    # actual cluster (rounded up to 8). The scan matmul cost is proportional
    # to block capacity, so packing to measured occupancy instead of the
    # pre-split worst case recovers ~3x scan cost at 10M scale; the headroom
    # above 1.0 is spare per-cluster space that add() appends into in O(new).
    block_headroom: float = 1.25
    seed: int = 0

    def __post_init__(self):
        if self.metric not in ("l2", "dot", "cosine"):
            raise ValueError(f"bad metric {self.metric!r}")

    @property
    def storage_dtype(self):
        # int8: symmetric per-vector codes + f32 scales (state.b_scales)
        return {
            "float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8,
        }[self.dtype]


class IVFState(NamedTuple):
    centroids: jax.Array   # [C, D] f32
    c_norms: jax.Array     # [C] f32 (squared norms; zeros for dot/cosine)
    blocks: jax.Array      # [C, Bcap, D] storage dtype (f32/bf16/int8 codes)
    b_norms: jax.Array     # [C, Bcap] f32, +inf padding
    b_scales: jax.Array    # [C, Bcap] f32 dequant scales (1.0 for float dtypes)
    b_ids: jax.Array       # [C, Bcap] int32 external ids, -1 padding
    counts: jax.Array      # [C] int32
    n: jax.Array           # scalar int32
    rerank_vecs: jax.Array   # [n, D] shadow vectors (ext-id order; [0,0] = off)
    rerank_norms: jax.Array  # [n] f32 exact squared norms


# ---------------------------------------------------------------------------
# k-means (device, matmul form)


@functools.partial(jax.jit, static_argnames=("tile",))
def _assign(x: jax.Array, xn: jax.Array, cent: jax.Array, cn: jax.Array, tile: int = 16384):
    """argmin_c ||x - c||^2 for all points, tiled over N. Returns [N] int32."""
    n = x.shape[0]
    pad = -(-n // tile) * tile - n
    xp = jnp.pad(x, ((0, pad), (0, 0)))
    xt = xp.reshape(-1, tile, x.shape[1])

    def body(_, xt_i):
        d = cn[None, :] - 2.0 * jnp.dot(
            xt_i, cent.T, preferred_element_type=jnp.float32
        )
        return None, jnp.argmin(d, axis=-1).astype(jnp.int32)

    _, a = jax.lax.scan(body, None, xt)
    return a.reshape(-1)[:n]


@functools.partial(jax.jit, donate_argnums=(2,))
def _update_centroids(x: jax.Array, assign: jax.Array, cent: jax.Array):
    """Lloyd update via one-hot matmul: cent_c = sum_{i: a_i=c} x_i / count_c."""
    c = cent.shape[0]
    onehot = jax.nn.one_hot(assign, c, dtype=jnp.bfloat16)          # [N, C]
    sums = jnp.dot(onehot.T, x.astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)               # [C, D]
    counts = jnp.sum(onehot, axis=0, dtype=jnp.float32)              # [C]
    new = sums / jnp.maximum(counts[:, None], 1.0)
    # empty clusters keep their previous centroid
    return jnp.where(counts[:, None] > 0, new, cent)


# ---------------------------------------------------------------------------
# device-side packing (one corpus upload; no host block assembly)


@functools.partial(
    jax.jit,
    static_argnames=("dtype_name", "metric"),
    donate_argnums=(5, 6, 7, 8),
)
def _pack_segment(
    xd, cent, order_seg, sa_seg, slot_seg,
    blocks, b_norms, b_scales, b_ids,
    dtype_name: str, metric: str,
):
    """Scatter one corpus segment into the block arrays (donated carries).

    Segmenting bounds the transient footprint: the one-shot pack at 10M x 96
    held corpus + gathered reorder + residuals + f32 shadows in a single jit
    (~17 GB transient) and ResourceExhausted the 16 GB chip; per-segment
    temporaries are ~segment-sized instead of corpus-sized.
    """
    npts = order_seg.shape[0]
    valid = order_seg >= 0
    safe = jnp.maximum(order_seg, 0)
    xo = jnp.take(xd, safe, axis=0)                          # [S, D]
    norms = D.sq_norms(xo) if metric == "l2" else jnp.zeros((npts,), jnp.float32)
    if dtype_name == "int8":
        resid = xo - jnp.take(cent, jnp.maximum(sa_seg, 0), axis=0)
        amax = jnp.max(jnp.abs(resid), axis=-1)
        scl = jnp.maximum(amax, 1e-12) / 127.0
        stored = jnp.clip(jnp.round(resid / scl[:, None]), -127, 127).astype(jnp.int8)
    else:
        dtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype_name]
        stored = xo.astype(dtype)
        scl = jnp.ones((npts,), jnp.float32)
    c = blocks.shape[0]
    wa = jnp.where(valid, sa_seg, c)        # invalid rows -> dropped (oob)
    blocks = blocks.at[wa, slot_seg].set(stored, mode="drop")
    b_norms = b_norms.at[wa, slot_seg].set(norms, mode="drop")
    b_scales = b_scales.at[wa, slot_seg].set(scl, mode="drop")
    b_ids = b_ids.at[wa, slot_seg].set(order_seg, mode="drop")
    return blocks, b_norms, b_scales, b_ids


@functools.partial(jax.jit, donate_argnums=(1, 2), static_argnames=("metric",))
def _shadow_segment(seg, rr, rrn, lo, metric: str):
    rr = jax.lax.dynamic_update_slice(rr, seg.astype(rr.dtype), (lo, 0))
    if metric == "l2":
        rrn = jax.lax.dynamic_update_slice(rrn, D.sq_norms(seg), (lo,))
    return rr, rrn


def _pack_device(
    xd: jax.Array,       # [N, D] f32 corpus, device-resident (preprocessed)
    cent: jax.Array,     # [C, D] f32
    order: jax.Array,    # [N] int32: points sorted by cluster
    sa: jax.Array,       # [N] int32: cluster of order[i]
    slot: jax.Array,     # [N] int32: block slot of order[i]
    c: int, cap: int, dtype_name: str, metric: str, rerank: int,
    rerank_dtype: str, rcap: int,
    segment: int = 2_000_000,
) -> IVFState:
    """Build IVFState on device from (order, cluster, slot) triples.

    One corpus upload (blocks are never assembled on the host and
    re-shipped); the scatter runs in corpus segments so transient buffers
    stay bounded at 10M+ scale.
    """
    n, dim = xd.shape
    blocks = jnp.zeros((c, cap, dim),
                       {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
                        "int8": jnp.int8}[dtype_name])
    b_norms = jnp.full((c, cap), jnp.inf, jnp.float32)
    b_scales = jnp.ones((c, cap), jnp.float32)
    b_ids = jnp.full((c, cap), -1, jnp.int32)

    seg = min(segment, max(n, 1))
    order_np, sa_np, slot_np = (np.asarray(order, np.int32),
                                np.asarray(sa, np.int32),
                                np.asarray(slot, np.int32))
    for lo in range(0, n, seg):
        hi = min(lo + seg, n)
        o = np.full(seg, -1, np.int32)
        s_ = np.zeros(seg, np.int32)
        sl = np.zeros(seg, np.int32)
        o[: hi - lo] = order_np[lo:hi]
        s_[: hi - lo] = sa_np[lo:hi]
        sl[: hi - lo] = slot_np[lo:hi]
        blocks, b_norms, b_scales, b_ids = _pack_segment(
            xd, cent, jnp.asarray(o), jnp.asarray(s_), jnp.asarray(sl),
            blocks, b_norms, b_scales, b_ids,
            dtype_name=dtype_name, metric=metric,
        )
    counts = jnp.zeros((c,), jnp.int32).at[jnp.asarray(sa_np)].add(1)

    if rerank:
        rr_dtype = jnp.float32 if rerank_dtype == "float32" else jnp.bfloat16
        # donated, segmented fill: an un-donated .at[:n].set of a corpus-sized
        # f32 buffer transiently doubles it (2 x 3.85 GB at 10M x 96) and
        # OOMed the chip on top of corpus + blocks
        rr = jnp.zeros((rcap, dim), rr_dtype)
        rrn = jnp.zeros((rcap,), jnp.float32)
        for lo in range(0, n, segment):
            hi = min(lo + segment, n)
            rr, rrn = _shadow_segment(
                jax.lax.slice(xd, (lo, 0), (hi, dim)), rr, rrn,
                jnp.asarray(lo, jnp.int32), metric=metric)
    else:
        rr = jnp.zeros((0, dim), jnp.bfloat16)
        rrn = jnp.zeros((0,), jnp.float32)
    return IVFState(
        centroids=cent,
        c_norms=D.sq_norms(cent) if metric == "l2" else jnp.zeros((c,), jnp.float32),
        blocks=blocks, b_norms=b_norms, b_scales=b_scales, b_ids=b_ids,
        counts=counts, n=jnp.asarray(n, jnp.int32), rerank_vecs=rr,
        rerank_norms=rrn,
    )


# ---------------------------------------------------------------------------
# balanced block assignment (host)


def _two_means(sub: np.ndarray, rng: np.random.Generator, iters: int = 4):
    """Tiny 2-means for cluster splitting (numpy; sub is one cluster's points)."""
    n = sub.shape[0]
    sel = rng.choice(n, 2, replace=False)
    c0, c1 = sub[sel[0]].copy(), sub[sel[1]].copy()
    for _ in range(iters):
        d0 = ((sub - c0) ** 2).sum(-1)
        d1 = ((sub - c1) ** 2).sum(-1)
        m0 = d0 <= d1
        if m0.all() or (~m0).all():
            m0 = np.arange(n) < n // 2
        c0 = sub[m0].mean(0)
        c1 = sub[~m0].mean(0)
    return c0, c1


@functools.partial(jax.jit, static_argnames=("iters",))
def _batched_two_means(xd, members, iters: int = 4):
    """Two-means over many clusters at once: members [O, M] int32 (-1 pad).
    Returns (c0 [O, D], c1 [O, D], side0 [O, M] bool). Init is deterministic
    (first member vs the count//2-th); degenerate one-sided splits fall back
    to an index-halves split, matching the host _two_means behavior."""
    valid = members >= 0
    safe = jnp.maximum(members, 0)
    pts = jnp.take(xd, safe, axis=0).astype(jnp.float32)       # [O, M, D]
    o, m, d = pts.shape
    counts = valid.sum(1)
    idx1 = jnp.maximum(counts // 2, 1)[:, None, None]
    c0 = pts[:, 0]
    c1 = jnp.take_along_axis(pts, jnp.broadcast_to(idx1, (o, 1, d)),
                             axis=1)[:, 0]
    iota = jnp.arange(m, dtype=jnp.int32)[None, :]
    m0 = valid & (iota % 2 == 0)
    for _ in range(iters):
        d0 = ((pts - c0[:, None]) ** 2).sum(-1)
        d1 = ((pts - c1[:, None]) ** 2).sum(-1)
        m0 = (d0 <= d1) & valid
        n0 = jnp.maximum(m0.sum(1), 1).astype(jnp.float32)
        n1 = jnp.maximum((valid & ~m0).sum(1), 1).astype(jnp.float32)
        c0 = jnp.einsum("om,omd->od", m0.astype(jnp.float32), pts) / n0[:, None]
        c1 = jnp.einsum("om,omd->od", (valid & ~m0).astype(jnp.float32),
                        pts) / n1[:, None]
    deg = (m0.sum(1) == counts) | (m0.sum(1) == 0)
    pos = jnp.cumsum(valid.astype(jnp.int32), axis=1) - 1
    half = valid & (pos < (counts // 2)[:, None])
    m0 = jnp.where(deg[:, None], half, m0)
    # recompute split centroids for the final sides so downstream probe
    # routing sees representative centers
    n0 = jnp.maximum(m0.sum(1), 1).astype(jnp.float32)
    n1 = jnp.maximum((valid & ~m0).sum(1), 1).astype(jnp.float32)
    c0 = jnp.einsum("om,omd->od", m0.astype(jnp.float32), pts) / n0[:, None]
    c1 = jnp.einsum("om,omd->od", (valid & ~m0).astype(jnp.float32),
                    pts) / n1[:, None]
    return c0, c1, m0


def split_oversized_device(xd, cent: np.ndarray, assign: np.ndarray,
                           cap: int):
    """Device-vectorized split_oversized: ALL oversized clusters of a round
    split in one batched two-means (the host loop measured 124-131 s at
    DEEP-10M — a pure single-core Python bottleneck; this runs in seconds).
    Semantics match split_oversized (two-means halving until every cluster
    fits); init differs (deterministic vs host-RNG seeds), which only
    perturbs which near-tied points land on which side."""
    cent = [c for c in cent]
    assign = assign.astype(np.int64).copy()

    def pow2(v):
        return 1 << max(int(np.ceil(np.log2(max(v, 1)))), 3)

    while True:
        counts = np.bincount(assign, minlength=len(cent))
        over = np.nonzero(counts > cap)[0]
        if len(over) == 0:
            break
        order = np.asarray(jnp.argsort(jnp.asarray(assign, jnp.int32)))
        sa = assign[order]
        starts = np.searchsorted(sa, over, side="left")
        ends = np.searchsorted(sa, over, side="right")
        sizes = ends - starts
        by_size = np.argsort(-sizes, kind="stable")
        # chunk by a member-table element budget with pow2-padded shapes:
        # unbounded [O, mmax] tables both OOMed the remote compile service
        # at DEEP-10M and minted a fresh 20-30 s compile per novel shape
        budget = 1 << 22
        pos = 0
        while pos < len(over):
            mmax = pow2(sizes[by_size[pos]])
            o_cap = max(1, budget // mmax)
            sel = by_size[pos: pos + o_cap]
            pos += len(sel)
            o_pad = pow2(len(sel))
            members = np.full((o_pad, mmax), -1, np.int32)
            for j, oi in enumerate(sel):
                members[j, : sizes[oi]] = order[starts[oi]:ends[oi]]
            c0, c1, side0 = _batched_two_means(xd, jnp.asarray(members))
            c0 = np.asarray(c0)
            c1 = np.asarray(c1)
            side0 = np.asarray(side0)
            for j, oi in enumerate(sel):
                c = over[oi]
                mem = members[j]
                live = mem >= 0
                cent[c] = c0[j]
                cent.append(c1[j])
                assign[mem[live & ~side0[j]]] = len(cent) - 1
    return np.asarray(cent, np.float32), assign


def split_oversized(x: np.ndarray, cent: np.ndarray, assign: np.ndarray,
                    cap: int, rng: np.random.Generator):
    """Split clusters that exceed `cap` into two local sub-clusters until all fit.

    This replaces capacity-displacement balancing: displacing a point to a
    far-away cluster with space makes it unreachable by realistic probe lists
    (on concentrated data the displaced cluster lands at an effectively random
    probe rank — measured as a hard recall ceiling). Splitting keeps every
    point under a centroid that genuinely represents it; probe ordering stays
    meaningful. Returns (centroids, assign) with len(centroids) grown.
    """
    cent = [c for c in cent]
    assign = assign.astype(np.int64).copy()
    while True:
        counts = np.bincount(assign, minlength=len(cent))
        over = np.where(counts > cap)[0]
        if len(over) == 0:
            break
        for c in over:
            pts = np.where(assign == c)[0]
            c0, c1 = _two_means(x[pts], rng)
            d0 = ((x[pts] - c0) ** 2).sum(-1)
            d1 = ((x[pts] - c1) ** 2).sum(-1)
            m0 = d0 <= d1
            if m0.all() or (~m0).all():
                m0 = np.arange(len(pts)) < len(pts) // 2
            cent[c] = c0
            cent.append(c1)
            assign[pts[~m0]] = len(cent) - 1
    return np.asarray(cent, np.float32), assign


# ---------------------------------------------------------------------------
# search


def ivf_search_impl(state: IVFState, q: jax.Array, k: int, nprobe: int,
                    metric: str, precision: str = "float32",
                    group_slack: float = 4.0,
                    c_mask: Optional[jax.Array] = None,
                    residual: bool = False,
                    rerank: int = 0,
                    id_map: Optional[jax.Array] = None,
                    allowed: Optional[jax.Array] = None,
                    filter_widen: int = 1):
    """Batched IVF search, query-grouped. Returns (user_scores [B,k], ext_ids [B,k]).

    `id_map` (optional [n_local] int32): b_ids are treated as LOCAL indices —
    into rerank shadow rows and id_map — and mapped to external ids only at
    the end. This is how the sharded path supports rerank: each shard stores
    its own densely-indexed shadow vectors plus a local->global map.

    Rationale: gathering each query's probed blocks is a per-row gather
    (gather granularity is the innermost row), which caps the naive scan far
    below memory bandwidth. Instead the (query, cluster) probe pairs are
    sorted by cluster so every cluster's block is read ONCE per batch and
    scored against all its probing queries with one batched matmul
    ('cqd,cbd->cqb') — the ScaNN-style grouped scan. Per-cluster query slots
    are capped at group_slack * mean occupancy; overflow pairs are dropped
    (rare at slack 4; raise for pathological query skew).
    """
    def body():
        qp = D.preprocess_queries(q, metric)
        b = qp.shape[0]
        c, bcap, d = state.blocks.shape
        p = nprobe
        cs = D.pairwise_scores(qp, state.centroids, state.c_norms, metric)  # [B, C]
        if c_mask is not None:  # sharded: padded cluster slots never probed
            cs = jnp.where(c_mask[None, :], cs, INF)
        if c >= 4096 and p * 4 <= c:
            # hardware partial top-k for probe selection: exact lax.top_k over
            # a many-thousand-cluster row is a fixed per-batch cost the probes
            # do not need (a ~97%-quality probe set loses ~0 end recall)
            _, probes = jax.lax.approx_min_k(cs, p)
        else:
            _, probes = jax.lax.top_k(-cs, p)                               # [B, P]

        # filtered search: widen the per-probe pool so enough candidates
        # survive the allowlist (the nearest ALLOWED rows can rank well
        # beyond the unfiltered top-k of their cluster)
        kk = min((k * rerank if rerank else k) * max(filter_widen, 1), bcap)
        if c * 8 > b * p:
            # ---- pair scan: one fat block gather per (query, probe) ------
            # The grouped path below scores C x q_cap slots no
            # matter how few are live — at DEEP-10M (C=22.7k) that fixed
            # ~300 ms/batch made QPS INVARIANT to nprobe. When clusters
            # outnumber probe pairs, gathering each pair's block rows
            # ([B*P, cap, D], ~150 KB fat rows at 10M int8) and scoring
            # [B*P, cap] directly has no empty slots and scales with nprobe.
            merged_s, merged_i = _pair_scan(
                state, qp, cs, probes, kk, metric, residual)
        else:
            merged_s, merged_i = _grouped_scan(
                state, qp, cs, probes, kk, metric, residual, group_slack)
        if allowed is not None:
            # filtered search: allowlist indexed by the ids merged_i carries
            # (global without id_map, local with). Applied on the P*kk-wide
            # candidate pool, before any rerank narrowing.
            ok = jnp.take(allowed, jnp.maximum(merged_i, 0)) & (merged_i >= 0)
            merged_s = jnp.where(ok, merged_s, INF)
            merged_i = jnp.where(ok, merged_i, -1)
        if rerank:
            cand_s, cand_i = T.smallest_k(merged_s, merged_i, min(k * rerank, merged_s.shape[-1]))
            cand_s, cand_i = T.mask_duplicate_ids(cand_s, cand_i)
            rv = jnp.take(state.rerank_vecs, jnp.maximum(cand_i, 0), axis=0)
            rn = jnp.take(state.rerank_norms, jnp.maximum(cand_i, 0), axis=0)
            ex = D.gathered_scores(qp, rv, rn, metric)
            ex = jnp.where(cand_i >= 0, ex, INF)
            best_s, best_i = T.smallest_k(ex, cand_i, k)
        else:
            best_s, best_i = T.smallest_k(merged_s, merged_i, k)

        user = D.finalize_scores(best_s, qp, metric)
        user = jnp.where(best_i >= 0, user, INF if metric == "l2" else -INF)
        if id_map is not None:
            best_i = jnp.where(
                best_i >= 0, jnp.take(id_map, jnp.maximum(best_i, 0)), -1
            )
        return user, best_i

    with D.precision_context(precision):
        return body()


def _pair_scan(state: IVFState, qp, cs, probes, kk: int, metric: str,
               residual: bool):
    """[B, P] probes -> (scores [B, P*kk], local ids [B, P*kk])."""
    b = qp.shape[0]
    c, bcap, d = state.blocks.shape
    p = probes.shape[1]
    pc = probes.reshape(-1)                                  # [B*P]
    blk = jnp.take(state.blocks, pc, axis=0)                 # [BP, cap, D]
    qv = jnp.repeat(qp, p, axis=0)                           # [BP, D]
    dots = jnp.einsum("pd,pbd->pb", qv, blk.astype(jnp.float32),
                      preferred_element_type=jnp.float32)    # [BP, cap]
    dots = dots * jnp.take(state.b_scales, pc, axis=0)
    if residual:
        qd = jnp.take_along_axis(cs, probes, axis=1).reshape(-1)  # [BP]
        if metric == "l2":
            qdotc = 0.5 * (jnp.take(state.c_norms, pc) - qd)
        else:
            qdotc = -qd
        qdotc = jnp.where(jnp.isfinite(qdotc), qdotc, 0.0)
        dots = dots + qdotc[:, None]
    bn = jnp.take(state.b_norms, pc, axis=0)
    s = bn - 2.0 * dots if metric == "l2" else -dots
    bi = jnp.take(state.b_ids, pc, axis=0)
    s = jnp.where(bi >= 0, s, INF)
    if bcap >= 4 * kk:
        ts, tpos = jax.lax.approx_min_k(s, kk)
    else:
        neg, tpos = jax.lax.top_k(-s, kk)
        ts = -neg
    ti = jnp.take_along_axis(bi, tpos, axis=-1)
    ti = jnp.where(jnp.isfinite(ts), ti, -1)
    return ts.reshape(b, p * kk), ti.reshape(b, p * kk)


def _grouped_scan(state: IVFState, qp, cs, probes, kk: int, metric: str,
                  residual: bool, group_slack: float):
    """ScaNN-style cluster-grouped scan -> (scores, local ids) [B, P*kk]."""
    b = qp.shape[0]
    c, bcap, d = state.blocks.shape
    p = probes.shape[1]
    if True:
        # ---- group probe pairs by cluster --------------------------------
        # Sort key (cluster, probe_rank): within a cluster, rank-0 probes get
        # slots before rank-(P-1) ones. Probe loads are heavily skewed ("magnet"
        # clusters near the data mean absorb everyone's low-rank probes —
        # measured max load 38x mean), so when slots run out the dropped pairs
        # must be the least valuable (high-rank probes of hot clusters), not
        # whichever queries sorted last.
        pair_c = probes.reshape(-1)                              # [B*P]
        pair_q = jnp.repeat(jnp.arange(b, dtype=jnp.int32), p)
        pair_p = jnp.tile(jnp.arange(p, dtype=jnp.int32), b)
        order = jnp.argsort(pair_c * p + pair_p, stable=True)
        sc_ = pair_c[order]
        sq_ = pair_q[order]
        sp_ = pair_p[order]
        rank = jnp.arange(b * p) - jnp.searchsorted(sc_, sc_, side="left")

        q_cap = max(8, int(group_slack * b * p / max(c, 1)))
        q_cap = min(q_cap, b * p)
        ok = rank < q_cap
        wc = jnp.where(ok, sc_, c)          # drop -> trash row c
        wr = jnp.where(ok, rank, 0)

        # per-cluster query slots (+1 trash cluster row)
        qslot = jnp.full((c + 1, q_cap), -1, jnp.int32).at[wc, wr].set(sq_)
        pslot = jnp.full((c + 1, q_cap), -1, jnp.int32).at[wc, wr].set(sp_)
        qslot, pslot = qslot[:c], pslot[:c]

        # ---- one batched matmul over all clusters ------------------------
        qv = jnp.take(qp, jnp.maximum(qslot, 0), axis=0)          # [C, Qcap, D]
        dots = jnp.einsum(
            "cqd,cbd->cqb", qv, state.blocks.astype(jnp.float32),
            preferred_element_type=jnp.float32,
        )                                                          # [C, Qcap, Bcap]
        dots = dots * state.b_scales[:, None, :]   # 1.0 for float dtypes
        if residual:
            # blocks hold residual codes: q.x = q.centroid + q.residual.
            # q.centroid is recovered exactly from the probe-scoring matmul:
            # l2 surrogate cs = ||cent||^2 - 2 q.cent; dot/cos: cs = bias - q.cent
            qd = jnp.take_along_axis(
                cs.T, jnp.maximum(qslot, 0), axis=1
            )                                                      # [C, Qcap]
            if metric == "l2":
                qdotc = 0.5 * (state.c_norms[:, None] - qd)
            else:
                qdotc = -qd
            qdotc = jnp.where(jnp.isfinite(qdotc), qdotc, 0.0)
            dots = dots + qdotc[:, :, None]
        if metric == "l2":
            s = state.b_norms[:, None, :] - 2.0 * dots
        else:
            s = -dots
        s = jnp.where(state.b_ids[:, None, :] >= 0, s, INF)
        s = jnp.where((qslot >= 0)[:, :, None], s, INF)

        ts, tpos = jax.lax.top_k(-s, kk)                           # [C, Qcap, kk]
        ts = -ts
        ti = jnp.take_along_axis(
            jnp.broadcast_to(state.b_ids[:, None, :], s.shape), tpos, axis=-1
        )
        ti = jnp.where(jnp.isfinite(ts), ti, -1)

        # ---- scatter back to per-query probe slots -----------------------
        out_s = jnp.full((b + 1, p, kk), INF, jnp.float32)
        out_i = jnp.full((b + 1, p, kk), -1, jnp.int32)
        wq = jnp.where(qslot >= 0, qslot, b)                       # drop -> trash
        wp = jnp.maximum(pslot, 0)
        out_s = out_s.at[wq, wp].set(ts)
        out_i = out_i.at[wq, wp].set(ti)
        merged_s = out_s[:b].reshape(b, p * kk)
        merged_i = out_i[:b].reshape(b, p * kk)
        return merged_s, merged_i


ivf_search = jax.jit(
    ivf_search_impl,
    static_argnames=("k", "nprobe", "metric", "precision", "group_slack",
                     "residual", "rerank", "filter_widen"),
)


@functools.partial(
    jax.jit, static_argnames=("metric", "max_results", "precision", "tile"))
def _ivf_range(cb: jax.Array, bn: jax.Array, bi: jax.Array, bs: jax.Array,
               q: jax.Array, radius: jax.Array,
               metric: str, max_results: int, precision: str = "float32",
               tile: int = 65536):
    """Exact range query over a flat (rows, norms, ids, scales) view.

    For float-dtype IVF the [C, Bcap, D] blocks are one contiguous (padded,
    permuted) copy of the corpus, so the exact scan is a reshape away —
    tiles of `tile` rows, lax.scan-accumulated (counts, running top-R).
    Padding / deleted rows carry ids < 0 or norm +inf and never count.
    Returns user-facing (scores [B, R], ids [B, R], counts [B])."""
    d = cb.shape[-1]
    rows = cb.shape[0]
    tile = min(tile, rows)
    pad = -(-rows // tile) * tile - rows
    if pad:
        cb = jnp.pad(cb, ((0, pad), (0, 0)))
        bn = jnp.pad(bn, (0, pad), constant_values=INF)
        bi = jnp.pad(bi, (0, pad), constant_values=-1)
        bs = jnp.pad(bs, (0, pad), constant_values=1.0)
    prec = D.matmul_precision(precision)
    qp = D.preprocess_queries(q, metric)
    b = qp.shape[0]
    is_l2 = metric == "l2"
    n_tiles = cb.shape[0] // tile
    cbt = cb.reshape(n_tiles, tile, d)
    bnt = bn.reshape(n_tiles, tile)
    bit = bi.reshape(n_tiles, tile)
    bst = bs.reshape(n_tiles, tile)

    def step(carry, xs):
        run_s, run_i, counts = carry
        v, nrm, ids, sc = xs
        s = D.pairwise_scores(qp, v, nrm, metric, precision=prec,
                              x_scales=sc)
        s = jnp.where(ids[None, :] >= 0, s, INF)
        user = D.finalize_scores(s, qp, metric)
        in_r = jnp.isfinite(s) & ((user <= radius) if is_l2
                                  else (user >= radius))
        counts = counts + jnp.sum(in_r, axis=-1).astype(jnp.int32)
        ts, ti = T.smallest_k(s, jnp.broadcast_to(ids[None, :], s.shape),
                              min(max_results, tile))
        run_s, run_i = T.merge_topk(run_s, run_i, ts, ti, max_results)
        return (run_s, run_i, counts), None

    init = (jnp.full((b, max_results), INF, jnp.float32),
            jnp.full((b, max_results), -1, jnp.int32),
            jnp.zeros((b,), jnp.int32))
    (run_s, run_i, counts), _ = jax.lax.scan(
        step, init, (cbt, bnt, bit, bst))
    user = D.finalize_scores(run_s, qp, metric)
    in_r = (run_i >= 0) & ((user <= radius) if is_l2 else (user >= radius))
    run_i = jnp.where(in_r, run_i, -1)
    user = jnp.where(in_r, user, INF if is_l2 else -INF)
    return user, run_i, counts


# ---------------------------------------------------------------------------
# incremental append (device)


@functools.partial(
    jax.jit, static_argnames=("metric", "dtype_name", "rerank"), donate_argnums=(0,)
)
def _ivf_append(
    state: IVFState,
    x: jax.Array,        # [B, D] f32, preprocessed (cosine already normalized)
    assign: jax.Array,   # [B] int32 target cluster per point
    valid: jax.Array,    # [B] bool — a PREFIX (padding only at the end)
    ext0: jax.Array,     # scalar int32: external id of x[0]
    metric: str,
    dtype_name: str,
    rerank: bool,
) -> IVFState:
    """Append a batch into spare per-cluster block capacity — O(batch), not O(N).

    Replaces the old full-rebuild flush (which destroyed int8 corpora by
    re-quantizing codes as raw vectors and reassigned every external id by
    position). External ids stay dense insertion-order: x[i] gets id ext0+i.
    The caller guarantees no target cluster overflows its capacity (checked on
    host; overflow falls back to a repack that reconstructs true vectors).
    """
    b = x.shape[0]
    c, bcap, _ = state.blocks.shape
    key = jnp.where(valid, assign, c)
    order = jnp.argsort(key, stable=True)            # cluster-sorted batch
    sa = key[order]
    rank = jnp.arange(b, dtype=jnp.int32) - jnp.searchsorted(
        sa, sa, side="left"
    ).astype(jnp.int32)
    counts_ext = jnp.concatenate([state.counts, jnp.zeros((1,), jnp.int32)])
    slot = jnp.take(counts_ext, sa) + rank           # [B] target slot in block
    xo = x[order]
    vo = valid[order]
    ext = ext0 + order.astype(jnp.int32)             # id of each sorted point

    if dtype_name == "int8":
        # residual codes against the (frozen) centroids, like _pack
        centv = jnp.take(state.centroids, jnp.minimum(sa, c - 1), axis=0)
        resid = xo - centv
        amax = jnp.max(jnp.abs(resid), axis=-1)
        scl = jnp.maximum(amax, 1e-12) / 127.0
        stored = jnp.clip(
            jnp.round(resid / scl[:, None]), -127, 127
        ).astype(jnp.int8)
    else:
        stored = xo.astype(state.blocks.dtype)
        scl = jnp.ones((b,), jnp.float32)
    norms = D.sq_norms(xo) if metric == "l2" else jnp.zeros((b,), jnp.float32)

    # invalid rows target slot=bcap (out of bounds) and are dropped
    ws = jnp.where(vo, slot, bcap)
    wc = jnp.minimum(sa, c - 1)
    blocks = state.blocks.at[wc, ws].set(stored, mode="drop")
    b_norms = state.b_norms.at[wc, ws].set(norms, mode="drop")
    b_scales = state.b_scales.at[wc, ws].set(scl, mode="drop")
    b_ids = state.b_ids.at[wc, ws].set(ext, mode="drop")
    counts = state.counts.at[jnp.minimum(sa, c - 1)].add(
        vo.astype(jnp.int32), mode="drop"
    )
    n = state.n + jnp.sum(vo).astype(jnp.int32)

    rr, rrn = state.rerank_vecs, state.rerank_norms
    if rerank:
        # shadow rows live at their external id; valid is a prefix so one
        # dynamic_update_slice covers the batch (padding rows are overwritten
        # by the next append — ids are dense)
        rr = jax.lax.dynamic_update_slice(rr, x.astype(rr.dtype), (ext0, 0))
        if metric == "l2":
            rrn = jax.lax.dynamic_update_slice(rrn, D.sq_norms(x), (ext0,))
    return IVFState(
        centroids=state.centroids, c_norms=state.c_norms, blocks=blocks,
        b_norms=b_norms, b_scales=b_scales, b_ids=b_ids, counts=counts, n=n,
        rerank_vecs=rr, rerank_norms=rrn,
    )


# ---------------------------------------------------------------------------
# public class


class IVFIndex:
    """IVF-Flat index. build/add/search/save/load, mirroring the engine API."""

    def __init__(self, cfg: IVFConfig):
        self.cfg = cfg
        self.state: Optional[IVFState] = None
        self._key = jax.random.PRNGKey(cfg.seed)
        self._lock = threading.RLock()
        self._pending: list[np.ndarray] = []
        self._n_inserted = 0
        self._dead: set[int] = set()   # tombstoned external ids

    def __len__(self) -> int:
        with self._lock:
            n = 0 if self.state is None else int(self.state.n)
            return (n + sum(p.shape[0] for p in self._pending)
                    - len(self._dead))

    # -- build ------------------------------------------------------------
    def build(self, x, checkpoint_path: Optional[str] = None) -> None:
        """Device-centric bulk build: ONE corpus upload, k-means + assignment
        + block packing all on device; the host handles only the int32
        cluster/slot bookkeeping (assembling blocks on the host and
        re-shipping them would double the transfer volume).

        checkpoint_path: snapshot the BUILD PLAN (centroids + the
        order/cluster/slot packing triples + the corpus) once the expensive,
        randomized phases (k-means, assignment, oversized-cluster split) have
        finished; recover with IVFIndex.resume_build(path) after a crash.
        The remaining pack phase is a deterministic function of the plan, so
        a resumed index is bit-identical to the uninterrupted build. The
        reference has no failure recovery at all (SURVEY.md §5); the DEEP-10M
        build is minutes long, dominated by exactly the phases the plan
        captures."""
        import os
        import time as _time

        from .knn_graph import _kmeans_device

        trace = os.environ.get("ZVDB_BUILD_TRACE", "") not in ("", "0")
        marks = [("start", _time.perf_counter())]

        def mark(name, *sync):
            if trace:
                if sync:
                    jax.block_until_ready(sync)
                marks.append((name, _time.perf_counter()))

        on_device = isinstance(x, jax.Array)
        if not on_device:
            x = np.asarray(x, np.float32)
        n = x.shape[0]
        if n == 0:   # empty corpus -> empty index
            with self._lock:
                self._pending = []
                self._n_inserted = 0
                self.state = None
                self._dead = set()
            return
        with self._lock:
            self._pending = []
            self._n_inserted = n
            self._dead = set()
            cfg = self.cfg
            if cfg.metric == "cosine":
                if on_device:
                    x = x / jnp.maximum(
                        jnp.linalg.norm(x, axis=1, keepdims=True), 1e-12)
                else:
                    x = x / np.maximum(
                        np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
            c = cfg.n_clusters or max(8, 1 << int(round(math.log2(4 * math.sqrt(max(n, 1))))))
            c = min(c, max(8, n))
            self._key, sub = jax.random.split(self._key)
            # device-resident corpora skip the upload entirely
            xd = jnp.asarray(x, jnp.float32)
            xn = D.sq_norms(xd) if cfg.metric == "l2" else jnp.zeros((n,), jnp.float32)
            cent = _kmeans_device(xd, c, cfg.kmeans_iters, sub,
                                  sample=min(n, cfg.kmeans_sample))
            mark("kmeans", cent)
            # l2 geometry drives assignment for every metric (cosine data is
            # normalized, dot uses the same centroid Voronoi structure)
            assign = np.asarray(
                _assign(xd, xn, cent, D.sq_norms(cent))
            ).astype(np.int64)
            mark("assign+pull")

            cap_split = int(math.ceil(cfg.max_cluster_factor * max(n, 1) / c / 8.0)) * 8
            cap_split = max(cap_split, 8)
            rng = np.random.default_rng(cfg.seed + 1)
            if n >= 500_000 or on_device:
                # device-vectorized split: the host two-means loop measured
                # 124-131 s at DEEP-10M on this 1-core host. Device-resident
                # corpora use it at EVERY size: the on-demand _DeviceRows
                # pulls mint a fresh remote compile per distinct oversized-
                # cluster gather shape (measured 100 s cold at 100k), while
                # the batched split's pow2 shape buckets bound compiles
                cent_np, assign = split_oversized_device(
                    xd, np.asarray(cent), assign, cap_split)
            else:
                cent_np, assign = split_oversized(
                    x, np.asarray(cent), assign, cap_split, rng)
            mark("split")
            cap = self._occupancy_cap(assign, len(cent_np))
            if n >= 500_000:   # host stable argsort measured 6-16 s at 10M
                order = np.asarray(
                    jnp.argsort(jnp.asarray(assign, jnp.int32))
                ).astype(np.int32)
            else:
                order = np.argsort(assign, kind="stable").astype(np.int32)
            sa = assign[order].astype(np.int32)
            first = np.searchsorted(sa, np.arange(len(cent_np)), side="left")
            slot = (np.arange(n) - first[sa]).astype(np.int32)
            mark("host-order")
            rcap = max(1024, -(-n // 1024) * 1024 + 1024) if cfg.rerank else 0
            if checkpoint_path:
                import dataclasses
                import json

                np.savez_compressed(
                    checkpoint_path,
                    meta=json.dumps(dict(kind="ivf_plan",
                                         cfg=dataclasses.asdict(cfg),
                                         cap=cap, rcap=rcap)),
                    corpus=np.asarray(x), cent=cent_np.astype(np.float32),
                    order=order, sa=sa, slot=slot,
                )
            self.state = self._pack_from_plan(xd, cent_np, order, sa, slot,
                                              cap, rcap)
            mark("pack", self.state)
            if trace:
                total = marks[-1][1] - marks[0][1]
                parts = "  ".join(f"{nm}={t1 - t0:.2f}s" for (_, t0), (nm, t1)
                                  in zip(marks, marks[1:]))
                print(f"[ivf build n={n}] total={total:.2f}s  {parts}",
                      flush=True)

    def _pack_from_plan(self, xd, cent_np, order, sa, slot, cap: int,
                        rcap: int) -> IVFState:
        cfg = self.cfg
        return _pack_device(
            xd, jnp.asarray(cent_np, jnp.float32), jnp.asarray(order),
            jnp.asarray(sa), jnp.asarray(slot),
            c=len(cent_np), cap=cap, dtype_name=cfg.dtype,
            metric=cfg.metric, rerank=cfg.rerank,
            rerank_dtype=cfg.rerank_dtype, rcap=rcap,
        )

    @classmethod
    def resume_build(cls, checkpoint_path: str) -> "IVFIndex":
        """Finish a crashed bulk build from its plan checkpoint. The pack is
        deterministic given the plan, so the result equals the direct build."""
        import json

        with np.load(checkpoint_path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            if meta.get("kind") != "ivf_plan":
                raise ValueError(f"not an IVF build checkpoint: {checkpoint_path}")
            cfg = IVFConfig(**meta["cfg"])
            idx = cls(cfg)
            x = z["corpus"]
            idx._n_inserted = x.shape[0]
            idx.state = idx._pack_from_plan(
                jnp.asarray(x, jnp.float32), z["cent"], z["order"], z["sa"],
                z["slot"], meta["cap"], meta["rcap"],
            )
        return idx

    def _occupancy_cap(self, assign: np.ndarray, c: int) -> int:
        """Block capacity from MEASURED occupancy: headroom * largest cluster.

        The grouped-scan matmul cost scales with block capacity, so packing to
        the pre-split worst case (max_cluster_factor * N/C) wastes up to ~3x
        scan time at 10M scale; the headroom above 1.0 is spare space that
        add() appends into without a repack."""
        max_count = int(np.bincount(assign, minlength=c).max()) if len(assign) else 1
        cap = int(math.ceil(self.cfg.block_headroom * max(max_count, 1) / 8.0)) * 8
        return max(cap, 8)

    def _nearest_assign(self, x: np.ndarray, cent: np.ndarray) -> np.ndarray:
        """True nearest-centroid assignment for every point (tiled, on device)."""
        n = x.shape[0]
        centj = jnp.asarray(cent)
        cn = D.sq_norms(centj)
        out = []
        tile = 16384
        for lo in range(0, n, tile):
            cs = D.pairwise_scores(jnp.asarray(x[lo:lo + tile]), centj, cn,
                                   self.cfg.metric)
            out.append(np.asarray(jnp.argmin(cs, axis=-1)))
        return np.concatenate(out) if out else np.zeros((0,), np.int64)

    def _pack(self, x: np.ndarray, cent: np.ndarray, assign: np.ndarray,
              cap: int) -> IVFState:
        cfg = self.cfg
        n = x.shape[0]
        c = cent.shape[0]
        blocks = np.zeros((c, cap, cfg.dim), np.float32)
        b_ids = np.full((c, cap), -1, np.int32)
        # vectorized packing: sort by cluster, slot = rank within cluster
        order = np.argsort(assign, kind="stable")
        sa = assign[order]
        first_pos = np.searchsorted(sa, np.arange(c), side="left")
        slot = np.arange(n) - first_pos[sa]
        blocks[sa, slot] = x[order]
        b_ids[sa, slot] = order.astype(np.int32)
        counts = np.bincount(assign, minlength=c).astype(np.int32)
        b_norms = (blocks ** 2).sum(-1).astype(np.float32) if cfg.metric == "l2" \
            else np.zeros((c, cap), np.float32)
        b_norms[b_ids < 0] = np.inf
        if cfg.dtype == "int8":
            # residual encoding: quantize (x - centroid). Residual magnitudes
            # are ~an order smaller than raw vectors, so int8 error shrinks
            # accordingly (measured: raw-int8 capped recall at ~0.83; residual
            # encoding recovers it). Search adds back q.centroid exactly from
            # the probe matmul it already computes.
            resid = blocks - cent[:, None, :]
            resid[b_ids < 0] = 0.0
            amax = np.abs(resid).max(axis=-1)
            b_scales = (np.maximum(amax, 1e-12) / 127.0).astype(np.float32)
            stored = np.clip(
                np.round(resid / b_scales[..., None]), -127, 127
            ).astype(np.int8)
        else:
            b_scales = np.ones((c, cap), np.float32)
            stored = blocks
        centj = jnp.asarray(cent, jnp.float32)
        if cfg.rerank:
            # shadow rows indexed by external id, capacity-padded so add()
            # can append in place (padding rows are never gathered: candidate
            # ids are always < n)
            rcap = max(1024, -(-n // 1024) * 1024 + 1024)
            rr_dtype = {"float32": np.float32, "bfloat16": jnp.bfloat16}[cfg.rerank_dtype]
            rr_np = np.zeros((rcap, cfg.dim), np.float32)
            rr_np[:n] = x
            rr = jnp.asarray(rr_np, rr_dtype)              # ext-id order
            rrn_np = np.zeros((rcap,), np.float32)
            if cfg.metric == "l2":
                rrn_np[:n] = (x.astype(np.float64) ** 2).sum(-1).astype(np.float32)
            rrn = jnp.asarray(rrn_np)
        else:
            rr = jnp.zeros((0, cfg.dim), jnp.bfloat16)
            rrn = jnp.zeros((0,), jnp.float32)
        return IVFState(
            centroids=centj,
            c_norms=D.sq_norms(centj) if cfg.metric == "l2"
            else jnp.zeros((c,), jnp.float32),
            blocks=jnp.asarray(stored, cfg.storage_dtype),
            b_norms=jnp.asarray(b_norms),
            b_scales=jnp.asarray(b_scales),
            b_ids=jnp.asarray(b_ids),
            counts=jnp.asarray(counts),
            n=jnp.asarray(n, jnp.int32),
            rerank_vecs=rr,
            rerank_norms=rrn,
        )

    # -- incremental add --------------------------------------------------
    def add(self, x) -> None:
        """Buffered incremental insert; rebuilds blocks on flush (centroids are
        kept once trained — standard IVF behavior)."""
        x = np.array(x, np.float32, copy=True)
        if x.ndim == 1:
            x = x[None, :]
        with self._lock:
            self._pending.append(x)
            self._n_inserted += x.shape[0]

    insert = add

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._pending:
            return
        new = np.concatenate(self._pending, axis=0)
        self._pending = []
        if self.state is None:
            self.build(new)
            return
        cfg = self.cfg
        if cfg.metric == "cosine":
            new = new / np.maximum(np.linalg.norm(new, axis=1, keepdims=True), 1e-12)
        base = self._n_inserted - new.shape[0]   # first new external id
        st = self.state
        c, bcap, _ = st.blocks.shape
        assign = self._nearest_assign(new, np.asarray(st.centroids))
        counts = np.asarray(st.counts)
        addc = np.bincount(assign, minlength=c)
        # O(new) device append, padded to a chunk multiple to bound compiles
        bsz = new.shape[0]
        chunk = 1 << max(10, int(math.ceil(math.log2(max(bsz, 1)))))
        overflow = int((counts + addc).max()) > bcap
        if cfg.rerank and base + chunk > st.rerank_vecs.shape[0]:
            # the PADDED extent must fit: dynamic_update_slice clamps
            # out-of-bounds starts, which would silently shift shadow rows
            overflow = True  # shadow array out of capacity — repack regrows it
        if overflow:
            self._repack_with_new(new, base)
            return
        xb = np.zeros((chunk, cfg.dim), np.float32)
        xb[:bsz] = new
        ab = np.zeros((chunk,), np.int32)
        ab[:bsz] = assign
        vb = np.zeros((chunk,), bool)
        vb[:bsz] = True
        self.state = _ivf_append(
            st, jnp.asarray(xb), jnp.asarray(ab), jnp.asarray(vb),
            jnp.asarray(base, jnp.int32), cfg.metric, cfg.dtype,
            rerank=bool(cfg.rerank),
        )

    def _reconstruct_all(self) -> np.ndarray:
        """Stored vectors of every live point, indexed by external id [n, D].

        Exact when rerank shadows exist or blocks are float; int8-without-rerank
        dequantizes residual codes (scale*code + centroid — within quantization
        error of the original, NOT byte-identical)."""
        st, cfg = self.state, self.cfg
        n = int(st.n)
        if cfg.rerank:
            return np.asarray(st.rerank_vecs[:n], np.float32)
        ids = np.asarray(st.b_ids)
        ids = np.where(ids <= -2, -2 - ids, ids)   # decode tombstones
        mask = ids >= 0
        blocks = np.asarray(st.blocks, np.float32)
        if cfg.dtype == "int8":
            blocks = blocks * np.asarray(st.b_scales)[..., None] \
                + np.asarray(st.centroids)[:, None, :]
        out = np.empty((n, blocks.shape[-1]), np.float32)
        out[ids[mask]] = blocks[mask]
        return out

    def _repack_with_new(self, new: np.ndarray, base: int) -> None:
        """Overflow path: rebuild blocks from TRUE vectors (reconstructed in
        external-id order, so every previously returned id stays valid) against
        the existing centroids, splitting clusters that no longer fit.
        Tombstoned rows ride along (their ids must stay occupied) and are
        re-marked after the pack assigns fresh slots."""
        x_all = np.concatenate([self._reconstruct_all(), new], axis=0)
        self._rebuild_with_centroids(x_all, np.asarray(self.state.centroids))
        self._apply_tombstones()

    def _apply_tombstones(self) -> None:
        """Re-encode self._dead into freshly packed b_ids (dead external id e
        is stored as -2 - e: every scan path masks b_ids >= 0, all metrics)."""
        if not self._dead or self.state is None:
            return
        ids_np = np.asarray(self.state.b_ids)
        dec = np.where(ids_np <= -2, -2 - ids_np, ids_np)
        hit = np.isin(dec, np.asarray(sorted(self._dead), np.int64)) \
            & (dec >= 0) & (ids_np >= 0)
        if not hit.any():
            return
        cc, ss = np.nonzero(hit)
        self.state = self.state._replace(
            b_ids=self.state.b_ids.at[jnp.asarray(cc), jnp.asarray(ss)].set(
                jnp.asarray(-2 - dec[cc, ss], jnp.int32)))

    # -- delete -------------------------------------------------------------
    def remove(self, ids) -> int:
        """Delete by external id (tombstone; the reference has no delete).
        Ids never renumber and freed slots are not reused. A dead point's
        block slot stays occupied (its id is encoded as -2 - id, which every
        scan already masks out for all metrics) until compact(). Returns the
        number of rows newly deleted."""
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
            self._dead.update(new)
            # encode just the new ones (one host pull of b_ids + one scatter)
            ids_np = np.asarray(self.state.b_ids)
            hit = np.isin(ids_np, np.asarray(new, np.int64))
            cc, ss = np.nonzero(hit)
            self.state = self.state._replace(
                b_ids=self.state.b_ids.at[
                    jnp.asarray(cc), jnp.asarray(ss)].set(
                        jnp.asarray(-2 - ids_np[cc, ss], jnp.int32)))
            return len(new)

    def compact(self) -> np.ndarray:
        """Rebuild without tombstoned rows; survivors renumber to [0, L) in
        former order. Returns the survivors' OLD external ids (new_id ==
        position)."""
        with self._lock:
            self._flush_locked()
            n = 0 if self.state is None else int(self.state.n)
            alive = np.ones(n, bool)
            if self._dead:
                alive[np.fromiter(self._dead, np.int64, len(self._dead))] = False
            live = np.flatnonzero(alive)
            if self.state is None or not self._dead:
                return live
            vecs = self._reconstruct_all()[live]
        self.build(vecs)
        return live

    def _rebuild_with_centroids(self, x: np.ndarray, cent: np.ndarray) -> None:
        cfg = self.cfg
        n = x.shape[0]
        c = cent.shape[0]
        cap = int(math.ceil(cfg.max_cluster_factor * max(n, 1) / c / 8.0)) * 8
        cap = max(cap, 8)
        assign = self._nearest_assign(x, cent)
        rng = np.random.default_rng(cfg.seed + 2)
        cent2, assign = split_oversized(x, cent, assign, cap, rng)
        self.state = self._pack(x, cent2, assign,
                                self._occupancy_cap(assign, len(cent2)))

    def get(self, ids) -> np.ndarray:
        """Stored vectors for external ids — the reference's search returns
        Node copies carrying the stored point (src/hnsw.zig:214,235;
        src/test_hnsw.zig:60-66 asserts retrievability). Returns [K, D] f32
        (dequantized for int8 storage; normalized for cosine, as stored)."""
        with self._lock:
            self._flush_locked()
            ids = np.atleast_1d(np.asarray(ids, np.int64))
            if self.state is None or ids.size == 0:
                return np.zeros((ids.size, self.cfg.dim), np.float32)
            n = int(self.state.n)
            if (ids < 0).any() or (ids >= n).any():
                raise IndexError(f"ids must be in [0, {n})")
            if self._dead and any(int(i) in self._dead for i in ids):
                raise IndexError("id was deleted")
            return self._reconstruct_all()[ids]

    # -- search -----------------------------------------------------------
    def search(self, q, k: int, nprobe: Optional[int] = None, allowed=None,
               filter_mode: str = "auto"):
        """allowed: optional allowlist (bool mask over ids or int id array).
        filter_mode "auto" (default): "scan" unless the corpus is past the
        measured crossover AND the filter is near-all-pass, where "probe"
        keeps recall and is sublinear (utils/filter_policy.py).
        filter_mode "scan": EXACT masked brute-force scan — float
        blocks are one contiguous corpus copy, int8-residual indexes scan
        the exact rerank shadow store (built with IVFConfig(rerank>0));
        int8 WITHOUT a shadow store falls back to "probe". Measured round 4
        (docs/PERF.md): the probe path at 8x widening still lost to 0.256
        recall at 1% selectivity while the scan is exact at flat-scan cost.
        filter_mode "probe": filter on the probe candidate pool (P*kk wide,
        widened 8x) — raise nprobe for selective filters."""
        if filter_mode not in ("auto", "scan", "probe"):
            raise ValueError(f"invalid filter_mode {filter_mode!r}")
        with self._lock:
            self._flush_locked()
            if filter_mode == "auto":
                from ..utils.filter_policy import resolve_filter_mode

                filter_mode = resolve_filter_mode(
                    "auto", allowed, self._n_inserted, alt="probe")
            q = jnp.asarray(q, jnp.float32)
            squeeze = q.ndim == 1
            if squeeze:
                q = q[None, :]
            if q.shape[-1] != self.cfg.dim:
                raise ValueError(
                    f"dimension mismatch: index dim {self.cfg.dim}, got {q.shape[-1]}"
                )
            scan_ok = self.cfg.dtype != "int8" or (
                self.state is not None
                and self.state.rerank_vecs.shape[-1] == self.cfg.dim
                and self.state.rerank_vecs.shape[0] > 1)
            if self.state is None:
                s = jnp.full((q.shape[0], k), INF if self.cfg.metric == "l2" else -INF)
                i = jnp.full((q.shape[0], k), -1, jnp.int32)
            elif allowed is not None and filter_mode == "scan" and scan_ok:
                from ..utils.masks import allowed_mask
                from .flat import masked_exact_search

                st = self.state
                dm = self.cfg.dim
                av = allowed_mask(allowed, self._n_inserted,
                                  max(self._n_inserted, 1))
                if self.cfg.dtype != "int8":
                    cb = st.blocks.reshape(-1, dm)
                    bi = st.b_ids.reshape(-1)
                    ok = (bi >= 0) & jnp.take(av, jnp.maximum(bi, 0))
                    bias = jnp.where(ok, 0.0, INF)
                    s, pos = masked_exact_search(
                        cb, st.b_norms.reshape(-1) + bias,
                        st.b_scales.reshape(-1), q, k, self.cfg.metric,
                        precision=("high" if self.cfg.precision == "default"
                                   else self.cfg.precision))
                    i = jnp.where(pos >= 0,
                                  jnp.take(bi, jnp.maximum(pos, 0)), -1)
                else:
                    # residual codes cannot be scanned exactly — use the
                    # exact rerank shadow store (ext-id order)
                    nr = st.rerank_vecs.shape[0]
                    ok = jnp.take(jnp.pad(av, (0, max(0, nr - av.shape[0])),
                                          constant_values=False),
                                  jnp.arange(nr))
                    # explicit live-count gate (shadow norms are 0, not +inf,
                    # for uningested rows — do not rely on the av padding)
                    ok = ok & (jnp.arange(nr, dtype=jnp.int32) < st.n)
                    if self._dead:
                        dead = np.fromiter(self._dead, np.int64,
                                           len(self._dead))
                        ok = ok.at[jnp.asarray(dead)].set(False)
                    bias = jnp.where(ok, 0.0, INF)
                    s, i = masked_exact_search(
                        st.rerank_vecs, st.rerank_norms + bias,
                        jnp.ones((nr,), jnp.float32), q, k, self.cfg.metric,
                        precision=("high" if self.cfg.precision == "default"
                                   else self.cfg.precision))
            else:
                allow_j = None
                if allowed is not None:
                    from ..utils.masks import allowed_mask

                    allow_j = allowed_mask(
                        allowed, int(self.state.n),
                        max(int(self.state.n), 1))
                np_ = min(nprobe or self.cfg.nprobe, self.state.centroids.shape[0])
                s, i = ivf_search(
                    self.state, q, k, np_, self.cfg.metric, self.cfg.precision,
                    residual=self.cfg.dtype == "int8",
                    rerank=self.cfg.rerank,
                    allowed=allow_j,
                    filter_widen=8 if allow_j is not None else 1,
                )
            if squeeze:
                return s[0], i[0]
            return s, i

    def search_range(self, q, radius: float, max_results: int = 128):
        """All neighbors within `radius` — EXACT, same contract as
        FlatIndex.search_range (squared-L2 <= radius for l2, similarity >=
        radius otherwise; returns (scores [B, R], ids [B, R], counts [B]),
        counts exact, rows hold the R best when truncated, invalid id -1).

        Range counts must be exact to be useful, and probes cannot bound a
        radius, so this deliberately bypasses the probe structure and scans
        the grouped block storage flat — the cost of one exact flat-scan
        pass over capacity (incl. block padding), NOT an nprobe-scaled cost.
        Deleted rows (negative-encoded b_ids) and padding are masked out.
        `radius` is traced: one compiled program serves every radius."""
        with self._lock:
            self._flush_locked()
            q = jnp.asarray(q, jnp.float32)
            squeeze = q.ndim == 1
            if squeeze:
                q = q[None, :]
            if q.shape[-1] != self.cfg.dim:
                raise ValueError(
                    f"dimension mismatch: index dim {self.cfg.dim}, "
                    f"got {q.shape[-1]}")
            if self.state is None:
                s = jnp.full((q.shape[0], max_results),
                             INF if self.cfg.metric == "l2" else -INF)
                i = jnp.full((q.shape[0], max_results), -1, jnp.int32)
                c = jnp.zeros((q.shape[0],), jnp.int32)
            else:
                st = self.state
                dm = self.cfg.dim
                if self.cfg.dtype != "int8":
                    # float blocks ARE the (permuted, padded) corpus
                    cb = st.blocks.reshape(-1, dm)
                    bn, bi = st.b_norms.reshape(-1), st.b_ids.reshape(-1)
                    bs = st.b_scales.reshape(-1)
                elif st.rerank_vecs.shape[-1] == dm and \
                        st.rerank_vecs.shape[0] > 1:
                    # int8 blocks hold RESIDUAL codes — scan the exact
                    # rerank shadow store (ext-id order) instead; deleted
                    # ids are masked from the host tombstone set
                    nr = st.rerank_vecs.shape[0]
                    cb, bn = st.rerank_vecs, st.rerank_norms
                    bi = jnp.arange(nr, dtype=jnp.int32)
                    # live-count gate: the shadow store is zero-initialized,
                    # so padding rows n..nr-1 have norms 0 (< INF) and would
                    # otherwise scan as valid zero vectors, inflating counts
                    # by nr-n at large radii (advisor r4, high)
                    bi = jnp.where(bi < st.n, bi, -1)
                    if self._dead:
                        dead = np.fromiter(self._dead, np.int64,
                                           len(self._dead))
                        bi = bi.at[jnp.asarray(dead)].set(-1)
                    bs = jnp.ones((nr,), jnp.float32)
                else:
                    raise ValueError(
                        "search_range on an int8 IVF index requires the "
                        "rerank shadow store (IVFConfig(rerank=...)): the "
                        "blocks hold residual codes, not corpus rows")
                s, i, c = _ivf_range(
                    cb, bn, bi, bs, q, jnp.asarray(radius, jnp.float32),
                    self.cfg.metric, max_results, self.cfg.precision)
            if squeeze:
                return s[0], i[0], c[0]
            return s, i, c

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        import json

        with self._lock:
            self._flush_locked()
            meta = dict(cfg=dataclasses.asdict(self.cfg),
                        n_inserted=self._n_inserted)
            arrays = {}
            if self.state is not None:
                arrays = {f: np.asarray(getattr(self.state, f))
                          for f in IVFState._fields}
                for key, v in arrays.items():
                    if str(v.dtype) == "bfloat16":  # npz cannot store bf16
                        arrays[key] = v.astype(np.float32)
            np.savez_compressed(path, meta=json.dumps(meta), **arrays)

    @classmethod
    def load(cls, path: str) -> "IVFIndex":
        import json

        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            cfg = IVFConfig(**meta["cfg"])
            idx = cls(cfg)
            idx._n_inserted = meta["n_inserted"]
            if "b_ids" in z:   # tombstones ride in the id encoding
                enc = np.asarray(z["b_ids"])
                idx._dead = set(int(-2 - v) for v in enc[enc <= -2])
            if "centroids" in z:
                idx.state = IVFState(
                    centroids=jnp.asarray(z["centroids"]),
                    c_norms=jnp.asarray(z["c_norms"]),
                    blocks=jnp.asarray(z["blocks"], cfg.storage_dtype),
                    b_norms=jnp.asarray(z["b_norms"]),
                    b_scales=jnp.asarray(z["b_scales"]),
                    b_ids=jnp.asarray(z["b_ids"]),
                    counts=jnp.asarray(z["counts"]),
                    n=jnp.asarray(z["n"]),
                    # shadow vectors are full-precision rescoring data — their
                    # dtype follows cfg.rerank_dtype, NEVER the block storage
                    # dtype (casting f32 shadows to int8 silently corrupts
                    # rerank: measured 4% id agreement after round-trip)
                    rerank_vecs=jnp.asarray(z["rerank_vecs"], jnp.float32
                                            if cfg.rerank_dtype == "float32"
                                            else jnp.bfloat16)
                    if "rerank_vecs" in z else jnp.zeros((0, cfg.dim), jnp.bfloat16),
                    rerank_norms=jnp.asarray(z["rerank_norms"])
                    if "rerank_norms" in z else jnp.zeros((0,), jnp.float32),
                )
        return idx
