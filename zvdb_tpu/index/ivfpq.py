"""IVF-PQ index: cluster-blocked 4-bit PQ codes + grouped ADC scan.

The sublinear SCALE tier. The flat PQ scan (index/pqflat.py) is linear in N:
every query pays the full corpus ADC scan. This engine combines:

  IVF layout (index/ivf.py): corpus grouped into k-means clusters stored as
      CONTIGUOUS blocks; probe selection is one q x centroids matmul.
  PQ codes (ops/pq.py): nibble-packed 4-bit codes scored by a one-hot LUT
      matmul with per-bin top-2 selection (ops/pq_grouped.py).
  int16 refine store: rescore-exact rerank of the candidate pool.

Search scans ONLY probed clusters: (query, cluster) pairs are slotted per
cluster (the ScaNN-style grouped layout of ivf._grouped_scan) and
pq_grouped_scan_bins reads each cluster's code block once per batch. Total
scan FLOPs are slack * P/C of a flat scan's — ~100x fewer at 30M with
C=8192, nprobe=16 — so the scale tier stops being a linear scan.

Codes are NON-residual (one global codebook set, trained on a corpus
sample): classic IVF-PQ encodes residuals (x - centroid), but a residual ADC
needs a per-(query, cluster) LUT — a [C*qcap, S*16] f32 materialization
(~800 MB/batch at 30M). The exact rescore is the recall lever, not ADC
precision: the int16 refine rerank repairs ranking from a global-code
candidate pool. What the pool must do is CONTAIN the true neighbors, which
probing solves orthogonally to code quality.

Replaces: the reference's single-tier scalar scan (src/hnsw.zig:182-224) at
memory-bound scale; mirrors the engine-family API (build/add/search/remove/
compact/save/load/get/search_range, filtered search via `allowed`).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import threading
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import distance as D
from ..ops import pq as PQ
from ..ops.flat_scan import interpret_mode, next_pow2
from ..ops.pq_grouped import grouped_geometry, pq_grouped_scan_bins_fused
from ..ops import topk as T
from ..utils.config import _VALID_METRICS

INF = jnp.inf


@dataclasses.dataclass(frozen=True)
class IVFPQConfig:
    """Config for the IVF-PQ scale engine.

    Defaults target a 30M x 96d operating point: 4-bit codes (n_codes=16 —
    REQUIRED by the grouped scan's 16-wide one-hot), int8-quantized LUT,
    int16 refine rerank. Not yet tuned on the H100."""

    dim: int
    metric: str = "l2"
    # PQ geometry: dsub = dim/n_sub of 4-8 with 4-bit codes. n_sub/2 bytes
    # of packed codes per vector. Must be a multiple of 8.
    n_sub: int = 16
    # IVF geometry: clusters default to ~4*sqrt(N) (pow2-rounded) at build.
    n_clusters: Optional[int] = None
    nprobe: int = 16
    # Refine store for the exact rerank: "int16" (2D+4 B/vec) is the
    # measured rescore-exact default; "int8" max compression; "none" the
    # pure-codes floor (recall then bounded by 4-bit ADC precision).
    refine: str = "int16"
    # Candidates per result entering the refine rerank. Deep rerank is
    # nearly free here (the scan dominates per-query cost at scale —
    # measured round 4: rr128 at 30M cost 6% QPS over rr64).
    rerank: int = 16
    # PQ codebook training (once, frozen; adds encode against them).
    train_sample: int = 32768
    pq_kmeans_iters: int = 8
    opq: bool = False
    opq_iters: int = 8
    # IVF k-means.
    ivf_kmeans_iters: int = 12
    kmeans_sample: int = 131072
    max_cluster_factor: float = 2.0
    block_headroom: float = 1.25
    # Grouped-scan geometry: per-(query, cluster) bin pool is
    # per_bin*l_bins wide; cluster capacity pads to a multiple of chunk.
    # l_bins is the recall lever: per-bin top-2 competition happens WITHIN a
    # cluster — exactly the rows closest to the query — so 4-bit ADC noise
    # evicts true neighbors from narrow pools (a 128-bin pool capped 1M
    # recall below 0.992 whatever the probe count or rerank depth).
    l_bins: int = 256
    chunk: int = 512
    per_bin: int = 2
    # LUT precision: "int8" (per-query quantized table, exact integer sums),
    # "default" (one bf16 pass), "high" (hi/lo split, two bf16 passes).
    scan_precision: str = "int8"
    # Per-cluster query-slot capacity = slack * B * P / C (pairs past a hot
    # cluster's capacity are dropped, rarest-first — see ivf._grouped_scan).
    group_slack: float = 4.0
    # Expected FINAL corpus size for chunked scale builds (30M+ corpora
    # cannot be device-resident as one f32 array next to their own index).
    # When the first build sees n < expected_rows, block capacity and the
    # refine store are pre-sized by the expected growth factor so subsequent
    # add() chunks append O(batch) without overflow repacks. The k-means /
    # split / codebook geometry still comes from the first chunk (the
    # mixture is assumed stationary — standard IVF train-on-sample
    # semantics). None = size for the built corpus only.
    expected_rows: Optional[int] = None
    seed: int = 0

    def __post_init__(self):
        if self.metric not in _VALID_METRICS:
            raise ValueError(
                f"metric must be one of {_VALID_METRICS}, got {self.metric!r}")
        if self.dim <= 0:
            raise ValueError("dim must be positive")
        if self.dim % self.n_sub != 0:
            raise ValueError(
                f"dim ({self.dim}) must be divisible by n_sub ({self.n_sub})")
        if self.n_sub % 8 != 0:
            raise ValueError("n_sub must be a multiple of 8 (scan layout)")
        if self.refine not in ("none", "int8", "int16", "float32",
                               "bfloat16"):
            raise ValueError(f"invalid refine {self.refine!r}")
        if self.l_bins < 32 or self.l_bins & (self.l_bins - 1):
            raise ValueError("l_bins must be a power of two >= 32")
        if self.chunk % self.l_bins != 0:
            raise ValueError("chunk must be a multiple of l_bins")
        if self.per_bin not in (1, 2):
            raise ValueError("per_bin must be 1 or 2")
        if self.scan_precision not in ("default", "high", "int8"):
            raise ValueError(f"invalid scan_precision {self.scan_precision!r}")

    @property
    def dsub(self) -> int:
        return self.dim // self.n_sub

    @property
    def nb(self) -> int:
        return self.n_sub // 2

    @property
    def refine_dtype(self):
        return {"int8": jnp.int8, "int16": jnp.int16,
                "float32": jnp.float32, "bfloat16": jnp.bfloat16,
                "none": jnp.float32}[self.refine]

    @property
    def bytes_per_vector(self) -> int:
        """Device bytes per vector (codes + norm + id + refine store)."""
        refine = {"none": 0, "int8": self.dim + 4, "int16": 2 * self.dim + 4,
                  "float32": 4 * self.dim, "bfloat16": 2 * self.dim}[self.refine]
        return self.n_sub // 2 + 8 + refine


class IVFPQState(NamedTuple):
    centroids: jax.Array     # [C, D] f32
    c_norms: jax.Array       # [C] f32 (sq norms for l2; zeros otherwise)
    codes_blocks: jax.Array  # [C, S//2, cap] uint8 nibble-packed PQ codes
    norms_blocks: jax.Array  # [C, cap] f32 decoded sq-norms; +inf invalid
    b_ids: jax.Array         # [C, cap] int32 ext ids; -1 pad, -2-id tombstone
    counts: jax.Array        # [C] int32
    codebooks: jax.Array     # [S, 16, dsub] f32 (frozen after training)
    rot: jax.Array           # [D, D] OPQ rotation or [0, 0] sentinel
    refine: jax.Array        # [rcap, D] refine rows (ext-id order) or [rcap, 0]
    r_scales: jax.Array      # [rcap] f32 dequant scales (int refine)
    n: jax.Array             # scalar int32 rows ingested (incl. tombstones)


# Repack corpora up to this size ride the device split path (one upload);
# larger ones stream host segments and skip the split (tests shrink this to
# exercise the streamed path at CPU scale).
_REPACK_SPLIT_MAX_ROWS = 4_000_000


# ---------------------------------------------------------------------------
# device pack


def _pack_rows_core(xo, ids_seg, sa_seg_slot,
                    codes_blocks, norms_blocks, b_ids, codebooks, rot,
                    metric: str):
    """Scatter one segment's PQ codes into the cluster blocks.

    xo [S, D] are the segment's rows (already gathered, any source);
    ids_seg [S] the external ids stored with them (< 0 = padding, dropped).
    sa_seg_slot packs (cluster, slot) as two columns."""
    sa_seg, slot_seg = sa_seg_slot[:, 0], sa_seg_slot[:, 1]
    valid = ids_seg >= 0
    codes = PQ.encode(PQ.apply_rotation(xo, rot), codebooks)
    packed = PQ.pack_nibbles(codes)                        # [S, nb]
    if metric == "l2":
        norms = PQ.decoded_sq_norms(codes, codebooks)
    else:
        norms = jnp.zeros((xo.shape[0],), jnp.float32)
    c = codes_blocks.shape[0]
    wa = jnp.where(valid, sa_seg, c)                       # invalid -> dropped
    codes_blocks = codes_blocks.at[wa, :, slot_seg].set(packed, mode="drop")
    norms_blocks = norms_blocks.at[wa, slot_seg].set(norms, mode="drop")
    b_ids = b_ids.at[wa, slot_seg].set(ids_seg, mode="drop")
    return codes_blocks, norms_blocks, b_ids


@functools.partial(
    jax.jit, static_argnames=("metric",), donate_argnums=(3, 4, 5))
def _pack_pq_segment(xd, order_seg, sa_seg_slot,
                     codes_blocks, norms_blocks, b_ids, codebooks, rot,
                     metric: str):
    """Device-corpus segment pack: gather order_seg rows from xd, scatter.

    Same segmented-scatter shape as ivf._pack_segment (bounds transient HBM
    at 30M+ scale); the stored payload is nibble-packed codes instead of
    vectors."""
    xo = jnp.take(xd, jnp.maximum(order_seg, 0), axis=0)   # [S, D]
    return _pack_rows_core(xo, order_seg, sa_seg_slot, codes_blocks,
                           norms_blocks, b_ids, codebooks, rot, metric)


@functools.partial(
    jax.jit, static_argnames=("metric",), donate_argnums=(3, 4, 5))
def _pack_pq_rows_segment(xo, ids_seg, sa_seg_slot,
                          codes_blocks, norms_blocks, b_ids, codebooks, rot,
                          metric: str):
    """Host-corpus segment pack: rows arrive pre-gathered (the repack path
    streams [S, D] host slices so the WHOLE corpus never has to sit on
    device next to the blocks it is building — the round-5 30M repack OOM)."""
    return _pack_rows_core(xo, ids_seg, sa_seg_slot, codes_blocks,
                           norms_blocks, b_ids, codebooks, rot, metric)


@functools.partial(jax.jit, donate_argnums=(1, 2), static_argnames=("metric", "refine"))
def _refine_segment(seg, rr, rrs, lo, metric: str, refine: str):
    """Fill one refine-store segment at ext-id offset lo (donated carries)."""
    if refine in ("int8", "int16"):
        rows, scales, _ = D.quantize_corpus(
            seg, metric, bits=8 if refine == "int8" else 16)
    else:
        rows = D.preprocess_queries(seg, metric).astype(rr.dtype)
        scales = jnp.ones((seg.shape[0],), jnp.float32)
    rr = jax.lax.dynamic_update_slice(rr, rows.astype(rr.dtype), (lo, 0))
    rrs = jax.lax.dynamic_update_slice(rrs, scales, (lo,))
    return rr, rrs


# ---------------------------------------------------------------------------
# search


def _slot_pairs(probes: jax.Array, b: int, p: int, c: int, q_cap: int):
    """(query, cluster) probe pairs -> per-cluster slots, rank-ordered.

    Same drop policy as ivf._grouped_scan: when a hot cluster overflows its
    q_cap slots, the dropped pairs are its HIGHEST-rank probes (sort key
    (cluster, probe_rank)), never whichever queries sorted last."""
    pair_c = probes.reshape(-1)                              # [B*P]
    pair_q = jnp.repeat(jnp.arange(b, dtype=jnp.int32), p)
    pair_p = jnp.tile(jnp.arange(p, dtype=jnp.int32), b)
    order = jnp.argsort(pair_c * p + pair_p, stable=True)
    sc_ = pair_c[order]
    sq_ = pair_q[order]
    sp_ = pair_p[order]
    rank = jnp.arange(b * p) - jnp.searchsorted(sc_, sc_, side="left")
    ok = rank < q_cap
    wc = jnp.where(ok, sc_, c)                               # drop -> trash row
    wr = jnp.where(ok, rank, 0)
    qslot = jnp.full((c + 1, q_cap), -1, jnp.int32).at[wc, wr].set(sq_)
    pslot = jnp.full((c + 1, q_cap), -1, jnp.int32).at[wc, wr].set(sp_)
    return qslot[:c], pslot[:c]


def probe_slots(state: IVFPQState, qp: jax.Array, nprobe: int,
                metric: str, group_slack: float,
                c_mask: Optional[jax.Array] = None):
    """Probe selection + per-cluster slotting + ADC tables: the inputs of
    the grouped scan for preprocessed queries qp [B, D]. Returns
    (lut [B, S, 16], qslot [C, qcap], pslot [C, qcap])."""
    b = qp.shape[0]
    c = state.codes_blocks.shape[0]
    p = min(nprobe, c)
    cs = D.pairwise_scores(qp, state.centroids, state.c_norms, metric)  # [B, C]
    if c_mask is not None:
        cs = jnp.where(c_mask[None, :], cs, INF)
    # probes are EXACT top-p: with approx_min_k (recall_target 0.95) here,
    # recall saturated below 0.992 from nprobe 8 through 64 at 1M x 128d —
    # missing the rank-0 cluster loses the true NN no matter how many
    # further probes follow. [B, C] top-p is a few-rows x wide-reduction
    # shape, where top_k is the right tool.
    _, probes = jax.lax.top_k(-cs, p)                                   # [B, P]
    # per-cluster query slots: a power of two >= 32 (the fused scan's
    # block shape), no more than the pairs that exist
    q_cap = min(next_pow2(max(32, int(group_slack * b * p / max(c, 1)))),
                next_pow2(max(32, b * p)))
    qslot, pslot = _slot_pairs(probes, b, p, c, q_cap)
    lut = PQ.adc_lut(PQ.apply_rotation(qp, state.rot), state.codebooks)
    return lut, qslot, pslot


def ivfpq_search_impl(
    state: IVFPQState, q: jax.Array, k: int, nprobe: int,
    metric: str, refine: str, rerank: int,
    l_bins: int, chunk: int, per_bin: int, scan_precision: str,
    group_slack: float,
    allowed: Optional[jax.Array] = None,
    id_map: Optional[jax.Array] = None,
    c_mask: Optional[jax.Array] = None,
):
    """Batched IVF-PQ search. Returns (user scores [B, k], ext ids [B, k]).

    Pipeline: probe matmul -> per-cluster slotting -> grouped ADC scan
    over probed blocks only (the fused kernel, ops/pq_grouped.py) ->
    position->id mapping -> per-query scatter -> top-(k*rerank) pool ->
    exact refine rescore -> top-k. `id_map`/`c_mask`
    serve the sharded wrapper (local ids + padded cluster slots), mirroring
    ivf.ivf_search_impl.
    """
    qp = D.preprocess_queries(q, metric)
    b = qp.shape[0]
    c, nb, cap = state.codes_blocks.shape
    p = min(nprobe, c)
    lut, qslot, pslot = probe_slots(state, qp, nprobe, metric, group_slack,
                                    c_mask)
    bin_s, bin_pos = pq_grouped_scan_bins_fused(
        lut, qslot, state.codes_blocks, state.norms_blocks,
        l_bins=l_bins, chunk=chunk, metric=metric,
        precision=scan_precision, per_bin=per_bin,
        interpret=interpret_mode())
    lw = per_bin * l_bins                                    # [C, qcap, lw]

    # positions index the PADDED cap. The candidate pool carries FLAT
    # positions (cluster * capp + pos), not external ids: mapping every bin
    # slot through b_ids would be a C*qcap*lw-element gather (33M elements at
    # 1M-scale defaults — ~0.2 s/batch at the measured ~7 ns/row gather
    # cost); flat positions are arithmetic, and only the k*rerank survivors
    # of the pool cut pay the id-table gather below.
    _, capp = grouped_geometry(cap, l_bins, chunk)
    ids_p = state.b_ids if capp == cap else jnp.pad(
        state.b_ids, ((0, 0), (0, capp - cap)), constant_values=-1)
    flatpos = (jnp.arange(c, dtype=jnp.int32)[:, None, None] * capp
               + bin_pos)                          # bin_pos -1 -> negative
    flatpos = jnp.where(bin_pos >= 0, flatpos, -1)

    # scatter back to per-query probe slots (trash row b absorbs empties)
    out_s = jnp.full((b + 1, p, lw), INF, jnp.float32)
    out_i = jnp.full((b + 1, p, lw), -1, jnp.int32)
    wq = jnp.where(qslot >= 0, qslot, b)
    wp = jnp.maximum(pslot, 0)
    out_s = out_s.at[wq, wp].set(bin_s)
    out_i = out_i.at[wq, wp].set(flatpos)
    merged_s = out_s[:b].reshape(b, p * lw)
    merged_i = out_i[:b].reshape(b, p * lw)

    def map_ids(pos):
        mapped = jnp.take(ids_p.reshape(-1), jnp.maximum(pos, 0))
        # padding (-1) and tombstones (-2-id) both come back negative
        return jnp.where(pos >= 0, jnp.maximum(mapped, -1), -1)

    if allowed is not None:
        # filtered probe mode: the allowlist needs external ids, so the
        # whole pool pays the mapping gather — the documented cost of
        # filter_mode="probe"; the default filter path is the exact masked
        # scan in IVFPQIndex.search, which never reaches here.
        merged_i = map_ids(merged_i)
        ok = jnp.take(allowed, jnp.maximum(merged_i, 0)) & (merged_i >= 0)
        merged_s = jnp.where(ok, merged_s, INF)
        merged_i = jnp.where(ok, merged_i, -1)

    # each corpus row lives in exactly one (cluster, bin) pool and a pool's
    # per_bin registers hold distinct rows, so merged ids are duplicate-free
    # per query by construction — no dedupe pass needed before the pool cut.
    kk = min(max(k * rerank, k) if refine != "none" else k, p * lw)
    if kk > 64:
        cand_s, cand_i = T.sort_smallest_k(merged_s, merged_i, kk)
        cand_s = jnp.where(cand_i >= 0, cand_s, INF)
    else:
        cand_s, cand_i = T.smallest_k(merged_s, merged_i, kk)
    if allowed is None:
        cand_i = map_ids(cand_i)                  # survivors only
    cand_s = jnp.where(cand_i >= 0, cand_s, INF)

    if refine != "none":
        safe = jnp.maximum(cand_i, 0)
        rv = jnp.take(state.refine, safe, axis=0).astype(jnp.float32)
        if refine in ("int8", "int16"):
            rv = rv * jnp.take(state.r_scales, safe, axis=0)[..., None]
        dots = jnp.einsum("bd,bcd->bc", qp, rv,
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
        if metric == "l2":
            ex = jnp.sum(rv * rv, axis=-1) - 2.0 * dots
        else:
            ex = -dots
        ex = jnp.where(cand_i >= 0, ex, INF)
        best_s, best_i = T.smallest_k(ex, cand_i, k)
    else:
        best_s, best_i = T.smallest_k(cand_s, cand_i, k)

    user = D.finalize_scores(best_s, qp, metric)
    user = jnp.where(best_i >= 0, user, INF if metric == "l2" else -INF)
    if id_map is not None:
        best_i = jnp.where(
            best_i >= 0, jnp.take(id_map, jnp.maximum(best_i, 0)), -1)
    return user, best_i


ivfpq_search = jax.jit(
    ivfpq_search_impl,
    static_argnames=("k", "nprobe", "metric", "refine", "rerank", "l_bins",
                     "chunk", "per_bin", "scan_precision", "group_slack"),
)


# ---------------------------------------------------------------------------
# incremental append


@functools.partial(
    jax.jit, static_argnames=("metric", "refine"), donate_argnums=(0,))
def _ivfpq_append(state: IVFPQState, x: jax.Array, assign: jax.Array,
                  valid: jax.Array, ext0: jax.Array,
                  metric: str, refine: str) -> IVFPQState:
    """Append a batch into spare per-cluster capacity — O(batch), not O(N).

    Same slotting scheme as ivf._ivf_append (cluster-sort the batch, slot =
    count + within-cluster rank); the payload is packed PQ codes encoded
    against the frozen codebooks. Caller guarantees no overflow."""
    b = x.shape[0]
    c, nb, cap = state.codes_blocks.shape
    key = jnp.where(valid, assign, c)
    order = jnp.argsort(key, stable=True)
    sa = key[order]
    rank = jnp.arange(b, dtype=jnp.int32) - jnp.searchsorted(
        sa, sa, side="left").astype(jnp.int32)
    counts_ext = jnp.concatenate([state.counts, jnp.zeros((1,), jnp.int32)])
    slot = jnp.take(counts_ext, sa) + rank
    xo = x[order]
    vo = valid[order]
    ext = ext0 + order.astype(jnp.int32)

    codes = PQ.encode(PQ.apply_rotation(xo, state.rot), state.codebooks)
    packed = PQ.pack_nibbles(codes)
    norms = (PQ.decoded_sq_norms(codes, state.codebooks)
             if metric == "l2" else jnp.zeros((b,), jnp.float32))

    ws = jnp.where(vo, slot, cap)                 # invalid -> dropped (oob)
    wc = jnp.minimum(sa, c - 1)
    codes_blocks = state.codes_blocks.at[wc, :, ws].set(packed, mode="drop")
    norms_blocks = state.norms_blocks.at[wc, ws].set(norms, mode="drop")
    b_ids = state.b_ids.at[wc, ws].set(ext, mode="drop")
    counts = state.counts.at[jnp.minimum(sa, c - 1)].add(
        vo.astype(jnp.int32), mode="drop")
    n = state.n + jnp.sum(vo).astype(jnp.int32)

    rr, rrs = state.refine, state.r_scales
    if refine != "none":
        rr, rrs = _refine_segment.__wrapped__(
            x, rr, rrs, ext0, metric=metric, refine=refine)
    return state._replace(codes_blocks=codes_blocks, norms_blocks=norms_blocks,
                          b_ids=b_ids, counts=counts, n=n,
                          refine=rr, r_scales=rrs)


# ---------------------------------------------------------------------------
# public class


class IVFPQIndex:
    """IVF-PQ scale engine: build/add/search/remove/compact/save/load/get,
    filtered search via `allowed`, exact search_range over the refine store.
    """

    def __init__(self, cfg: IVFPQConfig):
        self.cfg = cfg
        self.state: Optional[IVFPQState] = None
        self._key = jax.random.PRNGKey(cfg.seed)
        self._lock = threading.RLock()
        self._pending: list[np.ndarray] = []
        self._n_inserted = 0
        self._trained = False
        self._dead: set[int] = set()

    def __len__(self) -> int:
        with self._lock:
            n = 0 if self.state is None else int(self.state.n)
            return (n + sum(p.shape[0] for p in self._pending)
                    - len(self._dead))

    @property
    def dim(self) -> int:
        return self.cfg.dim

    # -- training -----------------------------------------------------------

    def _train(self, xf: jax.Array):
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
            rot, cb = PQ.train_opq(xs, key, cfg.n_sub, 16,
                                   cfg.pq_kmeans_iters, cfg.opq_iters)
            return cb, rot
        return (PQ.train_codebooks(xs, key, cfg.n_sub, 16,
                                   cfg.pq_kmeans_iters),
                jnp.zeros((0, 0), jnp.float32))

    # -- build --------------------------------------------------------------

    def build(self, x) -> None:
        """Device-centric bulk build: ONE corpus upload; PQ training, IVF
        k-means, assignment, split, and the packed-code scatter all run on
        device (the ivf.py build skeleton with a PQ-code payload)."""
        import os
        import time as _time

        from .ivf import _assign, split_oversized_device
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
        with self._lock:
            self._pending = []
            self._n_inserted = n
            self._dead = set()
            self._trained = False
            self.state = None
            if n == 0:
                return
            cfg = self.cfg
            xd = jnp.asarray(x, jnp.float32)
            if cfg.metric == "cosine":
                xd = xd / jnp.maximum(
                    jnp.linalg.norm(xd, axis=1, keepdims=True), 1e-12)
            cb, rot = self._train(xd)
            self._trained = True
            mark("pq-train", cb)

            n_plan = max(n, cfg.expected_rows or 0)
            c = cfg.n_clusters or max(
                8, 1 << int(round(math.log2(4 * math.sqrt(max(n_plan, 1))))))
            c = min(c, max(8, n))
            self._key, sub = jax.random.split(self._key)
            cent = _kmeans_device(xd, c, cfg.ivf_kmeans_iters, sub,
                                  sample=min(n, cfg.kmeans_sample))
            mark("kmeans", cent)
            xn = D.sq_norms(xd) if cfg.metric == "l2" else jnp.zeros((n,), jnp.float32)
            assign = np.asarray(_assign(xd, xn, cent, D.sq_norms(cent))
                                ).astype(np.int64)
            mark("assign+pull")
            cap_split = int(math.ceil(
                cfg.max_cluster_factor * max(n, 1) / c / 8.0)) * 8
            cap_split = max(cap_split, 8)
            cent_np, assign = split_oversized_device(
                xd, np.asarray(cent), assign, cap_split)
            mark("split")
            c2 = len(cent_np)
            max_count = int(np.bincount(assign, minlength=c2).max())
            grow = max(1.0, (cfg.expected_rows or 0) / n)
            cap = max(8, int(math.ceil(
                cfg.block_headroom * grow * max(max_count, 1) / 8.0)) * 8)
            if n >= 500_000:
                order = np.asarray(jnp.argsort(jnp.asarray(assign, jnp.int32))
                                   ).astype(np.int32)
            else:
                order = np.argsort(assign, kind="stable").astype(np.int32)
            sa = assign[order].astype(np.int32)
            first = np.searchsorted(sa, np.arange(c2), side="left")
            slot = (np.arange(n) - first[sa]).astype(np.int32)
            mark("host-order")
            self.state = self._pack(xd, cent_np, order, sa, slot, c2, cap,
                                    cb, rot)
            mark("pack", self.state)
            if trace:
                total = marks[-1][1] - marks[0][1]
                parts = "  ".join(f"{nm}={t1 - t0:.2f}s" for (_, t0), (nm, t1)
                                  in zip(marks, marks[1:]))
                print(f"[ivfpq build n={n}] total={total:.2f}s  {parts}",
                      flush=True)

    def _pack(self, xd, cent_np, order, sa, slot, c: int, cap: int,
              cb, rot, segment: int = 2_000_000) -> IVFPQState:
        """xd may be a DEVICE array (bulk build: one upload, device gathers)
        or a HOST ndarray (the repack path: segments are host-gathered and
        streamed so the whole corpus never rides HBM next to the blocks)."""
        cfg = self.cfg
        n = xd.shape[0]
        host_corpus = isinstance(xd, np.ndarray)
        cent = jnp.asarray(cent_np, jnp.float32)
        codes_blocks = jnp.zeros((c, cfg.nb, cap), jnp.uint8)
        norms_blocks = jnp.full((c, cap), jnp.inf, jnp.float32)
        b_ids = jnp.full((c, cap), -1, jnp.int32)
        seg = min(segment, max(n, 1))
        for lo in range(0, n, seg):
            hi = min(lo + seg, n)
            o = np.full(seg, -1, np.int32)
            ss = np.zeros((seg, 2), np.int32)
            o[: hi - lo] = order[lo:hi]
            ss[: hi - lo, 0] = sa[lo:hi]
            ss[: hi - lo, 1] = slot[lo:hi]
            if host_corpus:
                xo = np.zeros((seg, cfg.dim), np.float32)
                xo[: hi - lo] = xd[order[lo:hi]]
                codes_blocks, norms_blocks, b_ids = _pack_pq_rows_segment(
                    jnp.asarray(xo), jnp.asarray(o), jnp.asarray(ss),
                    codes_blocks, norms_blocks, b_ids, cb, rot,
                    metric=cfg.metric)
            else:
                codes_blocks, norms_blocks, b_ids = _pack_pq_segment(
                    xd, jnp.asarray(o), jnp.asarray(ss),
                    codes_blocks, norms_blocks, b_ids, cb, rot,
                    metric=cfg.metric)
        counts = jnp.zeros((c,), jnp.int32).at[jnp.asarray(sa)].add(1)

        refine_d = cfg.dim if cfg.refine != "none" else 0
        n_plan = max(n, cfg.expected_rows or 0)
        rcap = max(1024, -(-n_plan // 1024) * 1024 + 1024) if refine_d else 1
        rr = jnp.zeros((rcap, refine_d), cfg.refine_dtype)
        rrs = jnp.ones((rcap,), jnp.float32)
        if refine_d:
            for lo in range(0, n, segment):
                hi = min(lo + segment, n)
                seg_rows = (jnp.asarray(xd[lo:hi]) if host_corpus
                            else jax.lax.slice(xd, (lo, 0), (hi, cfg.dim)))
                rr, rrs = _refine_segment(
                    seg_rows, rr, rrs,
                    jnp.asarray(lo, jnp.int32), metric=cfg.metric,
                    refine=cfg.refine)
        return IVFPQState(
            centroids=cent,
            c_norms=D.sq_norms(cent) if cfg.metric == "l2"
            else jnp.zeros((c,), jnp.float32),
            codes_blocks=codes_blocks, norms_blocks=norms_blocks,
            b_ids=b_ids, counts=counts, codebooks=cb, rot=rot,
            refine=rr, r_scales=rrs, n=jnp.asarray(n, jnp.int32),
        )

    # -- incremental add ----------------------------------------------------

    def add(self, x) -> None:
        """Buffered incremental insert (centroids + codebooks frozen once
        trained). First insert on an empty index trains + builds."""
        x = np.array(x, np.float32, copy=True)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[-1] != self.cfg.dim:
            raise ValueError(
                f"dimension mismatch: index dim {self.cfg.dim}, "
                f"got {x.shape[-1]}")
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
            new = new / np.maximum(
                np.linalg.norm(new, axis=1, keepdims=True), 1e-12)
        base = self._n_inserted - new.shape[0]
        st = self.state
        c, nb, cap = st.codes_blocks.shape
        assign = self._nearest_assign(new, np.asarray(st.centroids))
        counts = np.asarray(st.counts)
        addc = np.bincount(assign, minlength=c)
        bsz = new.shape[0]
        # pow2 padding bounds distinct append-program shapes; but the padded
        # refine write touches rows [base, base+chunk), and the pow2
        # overshoot past an exactly-pre-sized store must not force a growth
        # copy (old+new stores coexisting OOMed the 30M run on the FINAL
        # chunk). Fall back to 1024-multiple padding when that alone fits —
        # base + ceil(bsz/1024)*1024 <= ceil(n_total/1024)*1024 + 1024
        # always, so a store pre-sized for expected_rows never grows.
        chunk = 1 << max(10, int(math.ceil(math.log2(max(bsz, 1)))))
        if cfg.refine != "none" and base + chunk > st.refine.shape[0]:
            chunk_1k = -(-bsz // 1024) * 1024
            if base + chunk_1k <= st.refine.shape[0]:
                chunk = chunk_1k
            else:
                self._grow_refine(base + chunk)
                st = self.state
        if int((counts + addc).max()) > cap:
            # Spill-to-neighbor: route rows whose nearest cluster is full to
            # their next-nearest centroid with spare capacity. Exactly as
            # sound as IVF probing itself — a non-residual code's ADC score
            # is cluster-independent; the cluster only decides WHETHER a row
            # is scanned, and a spilled row sits where nprobe >= 2 searches
            # already look. Repack (O(N)) only when spill fails or the blocks
            # are globally near-full (> 90% occupancy: the pre-sizing is
            # exhausted, spill would degrade persistently) — the r5 30M run
            # died repacking 28M rows it could have spilled around.
            spilled = self._assign_with_spill(new, assign, counts, cap)
            occupancy = (int(counts.sum()) + bsz) / float(c * cap)
            frac = (np.count_nonzero(spilled != assign) / max(bsz, 1)
                    if spilled is not None else 1.0)
            if spilled is None or occupancy > 0.90 or frac > 0.20:
                self._repack_with_new(new, base)
                return
            assign = spilled
        xb = np.zeros((chunk, cfg.dim), np.float32)
        xb[:bsz] = new
        ab = np.zeros((chunk,), np.int32)
        ab[:bsz] = assign
        vb = np.zeros((chunk,), bool)
        vb[:bsz] = True
        self.state = _ivfpq_append(
            st, jnp.asarray(xb), jnp.asarray(ab), jnp.asarray(vb),
            jnp.asarray(base, jnp.int32), cfg.metric, cfg.refine)

    def _nearest_assign(self, x: np.ndarray, cent: np.ndarray) -> np.ndarray:
        n = x.shape[0]
        centj = jnp.asarray(cent)
        cn = D.sq_norms(centj)
        out = []
        for lo in range(0, n, 16384):
            cs = D.pairwise_scores(jnp.asarray(x[lo:lo + 16384]), centj, cn,
                                   self.cfg.metric)
            out.append(np.asarray(jnp.argmin(cs, axis=-1)))
        return np.concatenate(out) if out else np.zeros((0,), np.int64)

    def _topk_assign(self, x: np.ndarray, cent: np.ndarray,
                     t: int) -> np.ndarray:
        """[n, t] nearest-centroid ids per row, best first (spill candidates)."""
        n = x.shape[0]
        centj = jnp.asarray(cent)
        cn = D.sq_norms(centj)
        t = min(t, cent.shape[0])
        out = []
        for lo in range(0, n, 16384):
            cs = D.pairwise_scores(jnp.asarray(x[lo:lo + 16384]), centj, cn,
                                   self.cfg.metric)
            out.append(np.asarray(jax.lax.top_k(-cs, t)[1], np.int64))
        return (np.concatenate(out) if out
                else np.zeros((0, t), np.int64))

    def _assign_with_spill(self, new: np.ndarray, assign: np.ndarray,
                           counts: np.ndarray, cap: int,
                           t: int = 8) -> Optional[np.ndarray]:
        """Resolve per-cluster block overflow by walking each displaced row
        down its top-t centroid list until it finds spare capacity.

        Vectorized passes: within an overfull cluster the batch rows ranked
        past the free slots move to their next candidate; up to t-1 rounds.
        Returns the adjusted assignment, or None if rows remain unplaced
        (capacity is genuinely exhausted -> caller repacks)."""
        c = counts.shape[0]
        cand = self._topk_assign(new, np.asarray(self.state.centroids), t)
        b = new.shape[0]
        rows = np.arange(b)
        cur = np.zeros(b, np.int64)
        assign = cand[rows, 0]
        free = np.maximum(cap - counts, 0)
        for _ in range(cand.shape[1] - 1):
            order = np.argsort(assign, kind="stable")
            sa = assign[order]
            first = np.searchsorted(sa, np.arange(c), side="left")
            rank = np.arange(b) - first[sa]
            over_sorted = rank >= free[sa]
            over = np.zeros(b, bool)
            over[order] = over_sorted
            if not over.any():
                return assign
            movable = over & (cur < cand.shape[1] - 1)
            if not movable.any():
                return None
            cur[movable] += 1
            assign[movable] = cand[rows[movable], cur[movable]]
        # final feasibility check after the last move
        addc = np.bincount(assign, minlength=c)
        return assign if int((counts + addc).max()) <= cap else None

    def _grow_refine(self, need: int) -> None:
        """Grow the refine store in place (device realloc + copy) — the
        refine overflow never needs the O(N) cluster repack."""
        st, cfg = self.state, self.cfg
        rcap = max(1024, -(-int(need * 1.25) // 1024) * 1024 + 1024)
        refine_d = st.refine.shape[1]
        rr = jnp.zeros((rcap, refine_d), st.refine.dtype)
        rr = jax.lax.dynamic_update_slice(rr, st.refine, (0, 0))
        rrs = jnp.ones((rcap,), jnp.float32)
        rrs = jax.lax.dynamic_update_slice(rrs, st.r_scales, (0,))
        self.state = st._replace(refine=rr, r_scales=rrs)

    def _reconstruct_all(self) -> np.ndarray:
        """Live vectors in external-id order [n, D]: exact (dequantized) from
        the refine store, else the PQ reconstruction."""
        st, cfg = self.state, self.cfg
        n = int(st.n)
        if cfg.refine != "none":
            rows = np.asarray(st.refine[:n], np.float32)
            if cfg.refine in ("int8", "int16"):
                rows = rows * np.asarray(st.r_scales[:n])[:, None]
            return rows
        ids = np.asarray(st.b_ids)
        ids = np.where(ids <= -2, -2 - ids, ids)
        mask = ids >= 0
        c, nb, cap = st.codes_blocks.shape
        packed = np.asarray(st.codes_blocks).transpose(0, 2, 1).reshape(-1, nb)
        codes = np.asarray(PQ.unpack_nibbles(jnp.asarray(packed), cfg.n_sub))
        dec = np.asarray(PQ.apply_rotation(
            PQ.decode(jnp.asarray(codes), st.codebooks), st.rot.T))
        out = np.zeros((n, cfg.dim), np.float32)
        out[ids[mask]] = dec.reshape(c, cap, cfg.dim)[mask]
        return out

    def _repack_with_new(self, new: np.ndarray, base: int) -> None:
        """Overflow path: re-pack TRUE vectors (refine store order preserved,
        so every previously returned id stays valid) against the existing
        centroids + codebooks, splitting clusters that no longer fit.

        HBM discipline (the round-5 30M lesson — repacking 28M rows as one
        device array next to the live blocks OOMed a 16 GB chip): pull the
        corpus to HOST, free the old state FIRST, assign/pack from streamed
        host segments, and skip the device cluster split past 4M rows (cap
        then comes from the true post-assign max count, trading block
        padding for never holding corpus + 2 states)."""
        from .ivf import split_oversized_device

        x_all = np.concatenate([self._reconstruct_all(), new], axis=0)
        cfg = self.cfg
        n = x_all.shape[0]
        cent = np.asarray(self.state.centroids)
        cb, rot = self.state.codebooks, self.state.rot
        self.state = None                     # frees blocks + refine on device
        assign = self._nearest_assign(x_all, cent).astype(np.int64)
        c = cent.shape[0]
        if n <= _REPACK_SPLIT_MAX_ROWS:
            xd = jnp.asarray(x_all, jnp.float32)
            cap_split = max(8, int(math.ceil(
                cfg.max_cluster_factor * max(n, 1) / c / 8.0)) * 8)
            cent_np, assign = split_oversized_device(xd, cent, assign,
                                                     cap_split)
        else:
            xd = x_all                        # host corpus -> streamed pack
            cent_np = cent
        c2 = len(cent_np)
        max_count = int(np.bincount(assign, minlength=c2).max())
        # Geometric growth: a repack on the add path means the previous
        # sizing is exhausted — re-size for >= 1.5x the current corpus (or
        # the declared expected_rows ratio if larger) so repacks amortize
        # like vector doubling instead of recurring every few chunks with
        # hot clusters saturated (which forces persistent far spills).
        grow = max(1.5, (cfg.expected_rows or 0) / max(n, 1))
        cap = max(8, int(math.ceil(
            cfg.block_headroom * grow * max(max_count, 1) / 8.0)) * 8)
        order = np.argsort(assign, kind="stable").astype(np.int32)
        sa = assign[order].astype(np.int32)
        first = np.searchsorted(sa, np.arange(c2), side="left")
        slot = (np.arange(n) - first[sa]).astype(np.int32)
        self.state = self._pack(xd, cent_np, order, sa, slot, c2, cap,
                                cb, rot)
        self._apply_tombstones()

    def _apply_tombstones(self) -> None:
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
                jnp.asarray(-2 - dec[cc, ss], jnp.int32)),
            norms_blocks=self.state.norms_blocks.at[
                jnp.asarray(cc), jnp.asarray(ss)].set(jnp.inf))

    # -- delete -------------------------------------------------------------

    def remove(self, ids) -> int:
        """Tombstone by external id (ids never renumber). The slot's norm
        flips to +inf (the kernel's validity channel) and its id is encoded
        -2-id; freed slots are not reused until compact()."""
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
            ids_np = np.asarray(self.state.b_ids)
            hit = np.isin(ids_np, np.asarray(new, np.int64))
            cc, ss = np.nonzero(hit)
            self.state = self.state._replace(
                b_ids=self.state.b_ids.at[
                    jnp.asarray(cc), jnp.asarray(ss)].set(
                        jnp.asarray(-2 - ids_np[cc, ss], jnp.int32)),
                norms_blocks=self.state.norms_blocks.at[
                    jnp.asarray(cc), jnp.asarray(ss)].set(jnp.inf))
            return len(new)

    def compact(self) -> np.ndarray:
        """Rebuild without tombstoned rows; survivors renumber to [0, L) in
        former order. Returns survivors' OLD external ids."""
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

    def get(self, ids) -> np.ndarray:
        """Stored vectors for external ids [K, D] f32 (near-exact from the
        refine store; the PQ reconstruction under refine='none')."""
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

    # -- search -------------------------------------------------------------

    def _refine_view(self):
        """(rows, sq-norms, per-row scales) over the refine store for the
        exact masked-scan/range paths — integer codes ride through
        pairwise_scores' x_scales dequant so no corpus-sized f32 copy is
        materialized. Norms are of the DEQUANTIZED rows (scale^2 * |codes|^2),
        so the scan is exact over the stored representation."""
        st, cfg = self.state, self.cfg
        nr = st.refine.shape[0]
        if cfg.refine in ("int8", "int16"):
            rn = (st.r_scales ** 2 * D.sq_norms(st.refine.astype(jnp.float32))
                  if cfg.metric == "l2" else jnp.zeros((nr,), jnp.float32))
            return st.refine, rn, st.r_scales
        rn = (D.sq_norms(st.refine.astype(jnp.float32))
              if cfg.metric == "l2" else jnp.zeros((nr,), jnp.float32))
        return st.refine, rn, jnp.ones((nr,), jnp.float32)

    def search(self, q, k: int, nprobe: Optional[int] = None,
               rerank: Optional[int] = None, allowed=None,
               filter_mode: str = "auto"):
        """Top-k. Per-call nprobe/rerank overrides (each distinct value is
        its own compiled program). Filtered search defaults to the EXACT
        masked scan over the refine store (round-4 measured policy —
        docs/PERF.md filtered-search section); "auto" (default) keeps the
        scan below the measured crossover and routes near-all-pass filters
        on huge corpora to "probe" (utils/filter_policy.py);
        filter_mode="probe" filters the probe candidate pool instead
        (raise nprobe for selective filters)."""
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
                    f"dimension mismatch: index dim {self.cfg.dim}, "
                    f"got {q.shape[-1]}")
            cfg = self.cfg
            scan_ok = cfg.refine != "none" and self.state is not None
            if self.state is None:
                s = jnp.full((q.shape[0], k),
                             INF if cfg.metric == "l2" else -INF)
                i = jnp.full((q.shape[0], k), -1, jnp.int32)
            elif allowed is not None and filter_mode == "scan" and scan_ok:
                from ..utils.masks import allowed_mask
                from .flat import masked_exact_search

                st = self.state
                nr = st.refine.shape[0]
                av = allowed_mask(allowed, self._n_inserted,
                                  max(self._n_inserted, 1))
                ok = jnp.take(jnp.pad(av, (0, max(0, nr - av.shape[0])),
                                      constant_values=False),
                              jnp.arange(nr))
                ok = ok & (jnp.arange(nr, dtype=jnp.int32) < st.n)
                if self._dead:
                    dead = np.fromiter(self._dead, np.int64, len(self._dead))
                    ok = ok.at[jnp.asarray(dead)].set(False)
                bias = jnp.where(ok, 0.0, INF)
                rows, rn, scl = self._refine_view()
                s, i = masked_exact_search(
                    rows, rn + bias, scl, q, k, cfg.metric, precision="high")
            else:
                allow_j = None
                if allowed is not None:
                    from ..utils.masks import allowed_mask

                    allow_j = allowed_mask(allowed, int(self.state.n),
                                           max(int(self.state.n), 1))
                s, i = ivfpq_search(
                    self.state, q, k,
                    min(nprobe or cfg.nprobe,
                        self.state.centroids.shape[0]),
                    cfg.metric, cfg.refine,
                    (rerank if rerank is not None else cfg.rerank)
                    * (8 if allow_j is not None else 1),
                    cfg.l_bins, cfg.chunk, cfg.per_bin, cfg.scan_precision,
                    cfg.group_slack, allowed=allow_j,
                )
            if squeeze:
                return s[0], i[0]
            return s, i

    def search_range(self, q, radius: float, max_results: int = 128):
        """Exact radius query over the refine store (same contract as
        FlatIndex.search_range; requires refine != 'none' — PQ codes cannot
        bound an exact radius)."""
        with self._lock:
            self._flush_locked()
            if self.cfg.refine == "none":
                raise ValueError(
                    "search_range on IVF-PQ requires a refine store "
                    "(IVFPQConfig(refine=...)): codes alone cannot answer "
                    "an exact radius query")
            from .ivf import _ivf_range

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
                nr = st.refine.shape[0]
                rows, rn, scl = self._refine_view()
                bi = jnp.arange(nr, dtype=jnp.int32)
                bi = jnp.where(bi < st.n, bi, -1)
                if self._dead:
                    dead = np.fromiter(self._dead, np.int64, len(self._dead))
                    bi = bi.at[jnp.asarray(dead)].set(-1)
                s, i, c = _ivf_range(
                    rows, rn, bi, scl, q,
                    jnp.asarray(radius, jnp.float32), self.cfg.metric,
                    max_results, "float32")
            if squeeze:
                return s[0], i[0], c[0]
            return s, i, c

    # -- persistence ----------------------------------------------------------

    def save(self, path: str) -> None:
        with self._lock:
            self._flush_locked()
            meta = dict(cfg=dataclasses.asdict(self.cfg),
                        n_inserted=self._n_inserted,
                        trained=self._trained)
            arrays = {}
            if self.state is not None:
                arrays = {f: np.asarray(getattr(self.state, f))
                          for f in IVFPQState._fields}
                if str(arrays["refine"].dtype) == "bfloat16":
                    arrays["refine"] = arrays["refine"].view(np.uint16)
            np.savez_compressed(path, meta=json.dumps(meta), **arrays)

    @classmethod
    def load(cls, path: str) -> "IVFPQIndex":
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            cfg = IVFPQConfig(**meta["cfg"])
            idx = cls(cfg)
            idx._n_inserted = meta["n_inserted"]
            idx._trained = meta["trained"]
            if "b_ids" in z:
                enc = np.asarray(z["b_ids"])
                idx._dead = set(int(-2 - v) for v in enc[enc <= -2])
                refine = z["refine"]
                if cfg.refine == "bfloat16" and refine.dtype == np.uint16:
                    import ml_dtypes
                    refine = refine.view(ml_dtypes.bfloat16)
                idx.state = IVFPQState(
                    centroids=jnp.asarray(z["centroids"]),
                    c_norms=jnp.asarray(z["c_norms"]),
                    codes_blocks=jnp.asarray(z["codes_blocks"]),
                    norms_blocks=jnp.asarray(z["norms_blocks"]),
                    b_ids=jnp.asarray(z["b_ids"]),
                    counts=jnp.asarray(z["counts"]),
                    codebooks=jnp.asarray(z["codebooks"]),
                    rot=jnp.asarray(z["rot"]),
                    refine=jnp.asarray(refine, cfg.refine_dtype),
                    r_scales=jnp.asarray(z["r_scales"]),
                    n=jnp.asarray(z["n"]),
                )
        return idx
