"""Fused flat scan + bin fold, a Pallas kernel on the Triton route.

The XLA flat scan (index/flat.py:_search) writes each [B, tile] score block
to device memory and reads it back for top-k selection. At D = 128 that is
8 B of f32 score for every 256 flops, far below the ratio at which a card's
tensor cores rather than its memory set the pace, so the unfused scan is
bound by score traffic. This kernel keeps the scores on chip:

  * The corpus is cut into segments of `seg_rows` rows; each program owns
    one (query block, segment) pair and loops over its segment in chunks of
    `l_bins` rows, scoring a chunk with one tensor-core dot.
  * Row c of a segment belongs to bin c % l_bins. The running [bq, l_bins]
    bin minima and their row ids stay in registers across the loop; each
    chunk folds in with one compare and two selects.
  * Each program writes its [bq, l_bins] bins once. The caller selects
    top-k from the pooled [B, n_seg * l_bins] bins with one small top-k.

Selection is exact within each (segment, bin) pool; a true neighbour is
lost only when a better row of the same segment shares its bin, so the
pool widens with N and the loss shrinks with more segments.

Replaces: the reference's scalar L2 loop + per-query heap
(src/hnsw.zig:182-224) at brute-force scale.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from . import topk as T

_NEG1 = -1
PRECISIONS = ("default", "high", "highest")


def _bins_kernel(q_ref, v_ref, n_ref, out_s_ref, out_i_ref, *,
                 l_bins: int, seg_rows: int, metric: str, precision: str,
                 per_bin: int):
    bq = q_ref.shape[0]
    seg = pl.program_id(1)
    q = q_ref[...]

    def dot(a, b, prec=jax.lax.Precision.DEFAULT):
        return pl.dot(a, b, trans_b=True, precision=prec)

    if precision == "high":
        # bf16x3: x = hi + lo, keep hi*hi + hi*lo + lo*hi (drop lo*lo)
        q_hi = q.astype(jnp.bfloat16)
        q_lo = (q - q_hi.astype(jnp.float32)).astype(jnp.bfloat16)
    else:
        q_hi = q.astype(jnp.bfloat16)
        q_lo = None

    def score(v):
        if precision == "highest":
            return dot(q, v.astype(jnp.float32), jax.lax.Precision.HIGHEST)
        v_hi = v.astype(jnp.bfloat16)
        d = dot(q_hi, v_hi)
        if precision == "high":
            v_lo = (v - v_hi.astype(jnp.float32)).astype(jnp.bfloat16)
            d = d + dot(q_hi, v_lo) + dot(q_lo, v_hi)
        return d

    factor = 2.0 if metric == "l2" else 1.0
    lane = jax.lax.broadcasted_iota(jnp.int32, (bq, l_bins), 1)

    def body(m, carry):
        rows = pl.ds(m * l_bins, l_bins)
        s = n_ref[rows][None, :] - factor * score(v_ref[rows, :])
        return fold_step(carry, s, seg * seg_rows + m * l_bins + lane)

    cur = jax.lax.fori_loop(0, seg_rows // l_bins, body,
                            fold_init((bq, l_bins), per_bin))
    for r in range(per_bin):
        out_s_ref[:, pl.ds(r * l_bins, l_bins)] = cur[2 * r]
        out_i_ref[:, pl.ds(r * l_bins, l_bins)] = cur[2 * r + 1]


def fold_init(shape, per_bin: int):
    """Empty running bins: per_bin (scores +inf, ids -1) pairs."""
    empty = (jnp.full(shape, jnp.inf, jnp.float32),
             jnp.full(shape, _NEG1, jnp.int32))
    return empty * per_bin


def fold_step(carry, s, ids):
    """Fold one [.., L] block of scores (row ids `ids`) into running bins
    (s1, i1) or (s1, i1, s2, i2): per bin, the best row, and with two pairs
    also the runner-up. Strict < keeps the earlier row on ties."""
    if len(carry) == 2:
        s1, i1 = carry
        take = s < s1
        return jnp.where(take, s, s1), jnp.where(take, ids, i1)
    s1, i1, s2, i2 = carry
    take1 = s < s1
    take2 = jnp.logical_and(jnp.logical_not(take1), s < s2)
    s2 = jnp.where(take1, s1, jnp.where(take2, s, s2))
    i2 = jnp.where(take1, i1, jnp.where(take2, ids, i2))
    return jnp.where(take1, s, s1), jnp.where(take1, ids, i1), s2, i2


def interpret_mode() -> bool:
    """The kernel compiles for the GPU; on the CPU (the test platform) it runs
    in the Pallas interpreter. No other backend has a path."""
    backend = jax.default_backend()
    if backend not in ("gpu", "cpu"):
        raise NotImplementedError(
            f"flat_scan_bins has no kernel for backend {backend!r}")
    return backend == "cpu"


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (Triton block shapes are powers of two)."""
    return 1 << max(0, (n - 1).bit_length())


def _pad_inputs(q, vectors, norms, l_bins, seg_rows, bq):
    """Pad queries to bq rows, D to a power of two >= 16 and the corpus to
    whole segments (padding rows carry +inf norms, so they never win a bin).
    Small corpora shrink the segment. Returns (qp, vp, norms_p, seg_rows)."""
    b, d = q.shape
    n = vectors.shape[0]
    seg_rows = min(seg_rows, max(l_bins, next_pow2(n)))
    pb = -(-b // bq) * bq - b
    pd = max(16, next_pow2(d)) - d
    pn = -(-n // seg_rows) * seg_rows - n
    qp = jnp.pad(q.astype(jnp.float32), ((0, pb), (0, pd)))
    if vectors.dtype != jnp.bfloat16:
        vectors = vectors.astype(jnp.float32)
    vp = jnp.pad(vectors, ((0, pn), (0, pd)))
    np_ = jnp.pad(norms.astype(jnp.float32), (0, pn), constant_values=jnp.inf)
    return qp, vp, np_, seg_rows


@functools.partial(
    jax.jit,
    static_argnames=("l_bins", "seg_rows", "metric", "precision", "per_bin"))
def flat_scan_bins_reference(q, vectors, norms, l_bins: int = 64,
                             seg_rows: int = 16384, metric: str = "l2",
                             precision: str = "default", per_bin: int = 2):
    """Plain jnp/lax version of flat_scan_bins (same inputs, same output
    layout and precision), left to XLA: each segment's [B, seg_rows] scores
    are materialized, then min/argmin-folded per bin."""
    b = q.shape[0]
    qp, vp, np_, seg_rows = _pad_inputs(q, vectors, norms, l_bins, seg_rows,
                                        1)
    n_seg = vp.shape[0] // seg_rows
    factor = 2.0 if metric == "l2" else 1.0

    def dot(a, c, prec=None):
        return jnp.dot(a, c.T, preferred_element_type=jnp.float32,
                       precision=prec)

    def one_segment(args):
        v, nrm, base = args
        if precision == "highest":
            d = dot(qp, v.astype(jnp.float32), jax.lax.Precision.HIGHEST)
        else:
            q_hi, v_hi = qp.astype(jnp.bfloat16), v.astype(jnp.bfloat16)
            d = dot(q_hi, v_hi)
            if precision == "high":
                q_lo = (qp - q_hi.astype(jnp.float32)).astype(jnp.bfloat16)
                v_lo = (v - v_hi.astype(jnp.float32)).astype(jnp.bfloat16)
                d = d + dot(q_hi, v_lo) + dot(q_lo, v_hi)
        bs, cols = T.bin_fold(nrm[None, :] - factor * d, l_bins, per_bin)
        return bs, jnp.where(cols >= 0, base + cols, _NEG1)

    bases = jnp.arange(n_seg, dtype=jnp.int32) * seg_rows
    bs, bi = jax.lax.map(one_segment, (
        vp.reshape(n_seg, seg_rows, -1), np_.reshape(n_seg, seg_rows), bases))
    width = n_seg * per_bin * l_bins
    return (bs.transpose(1, 0, 2).reshape(b, width),
            bi.transpose(1, 0, 2).reshape(b, width))


@functools.partial(
    jax.jit,
    static_argnames=("l_bins", "seg_rows", "bq", "metric", "precision",
                     "per_bin", "num_warps", "num_stages", "interpret"),
)
def flat_scan_bins(
    q: jax.Array,           # [B, D] f32 preprocessed queries
    vectors: jax.Array,     # [N, D] f32 or bf16 corpus (storage rows)
    norms: jax.Array,       # [N] f32 squared norms; +inf marks invalid rows
    l_bins: int = 64,
    seg_rows: int = 16384,
    bq: int = 128,
    metric: str = "l2",
    precision: str = "default",
    per_bin: int = 2,
    num_warps: int = 8,
    num_stages: int = 2,
    interpret: bool = False,
):
    """Fold the corpus into per-segment bins.

    Returns (bin_scores [B, n_seg * per_bin * l_bins] f32 surrogate scores,
    bin_ids [B, n_seg * per_bin * l_bins] int32 row ids, -1 where a bin saw
    no valid row). Per segment, the first l_bins columns hold each bin's
    best row and, with per_bin=2, the next l_bins its runner-up.
    Surrogates follow the repo convention: ||x||^2 - 2 q.x for l2 (query
    norm not added), -q.x otherwise. l_bins, seg_rows and bq must be powers
    of two (Triton block shapes), seg_rows a multiple of l_bins, and
    l_bins, bq >= 16 (the tensor-core dot's minimum).
    """
    assert precision in PRECISIONS, precision
    for v in (l_bins, seg_rows, bq):
        assert v >= 16 and v == next_pow2(v), "block sizes: powers of two"
    assert seg_rows % l_bins == 0, "seg_rows must be a multiple of l_bins"
    b = q.shape[0]
    qp, vp, np_, seg_rows = _pad_inputs(q, vectors, norms, l_bins, seg_rows,
                                        bq)
    n_seg = vp.shape[0] // seg_rows
    grid = (qp.shape[0] // bq, n_seg)

    assert per_bin in (1, 2)
    kernel = functools.partial(_bins_kernel, l_bins=l_bins, seg_rows=seg_rows,
                               metric=metric, precision=precision,
                               per_bin=per_bin)
    width = per_bin * l_bins
    bin_s, bin_i = pl.pallas_call(
        kernel,
        grid=grid,
        in_specs=[
            pl.BlockSpec((bq, qp.shape[1]), lambda i, j: (i, 0)),
            pl.BlockSpec((seg_rows, vp.shape[1]), lambda i, j: (j, 0)),
            pl.BlockSpec((seg_rows,), lambda i, j: (j,)),
        ],
        out_specs=[
            pl.BlockSpec((bq, width), lambda i, j: (i, j)),
            pl.BlockSpec((bq, width), lambda i, j: (i, j)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((qp.shape[0], n_seg * width), jnp.float32),
            jax.ShapeDtypeStruct((qp.shape[0], n_seg * width), jnp.int32),
        ],
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=num_warps, num_stages=num_stages),
        interpret=interpret,
        name="flat_scan_bins",
    )(qp, vp, np_)
    return bin_s[:b], bin_i[:b]


def flat_scan_topk(q, vectors, norms, k: int, **kw):
    """Fused brute-force top-k: the bin fold, then one exact top-k over the
    pooled bins. Returns (scores [B, k] surrogate, ids [B, k]); invalid
    slots +inf / -1."""
    bin_s, bin_i = flat_scan_bins(q, vectors, norms, **kw)
    kk = min(k, bin_s.shape[1])
    scores, ids = T.smallest_k(bin_s, bin_i, kk)
    scores = jnp.where(ids >= 0, scores, jnp.inf)
    if kk < k:
        scores = jnp.pad(scores, ((0, 0), (0, k - kk)), constant_values=jnp.inf)
        ids = jnp.pad(ids, ((0, 0), (0, k - kk)), constant_values=-1)
    return scores, ids
