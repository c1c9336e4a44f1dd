"""Batched distance kernels in matmul form.

Replacement for the reference's scalar inner loop (reference
src/hnsw.zig:182-192: squared-L2, element-by-element, panics on dim
mismatch). Here every distance is a matrix product so the tensor cores do
the FLOPs:

    ||q - x||^2 = ||q||^2 - 2 q.x + ||x||^2

Internally the engine ranks by a *monotone surrogate* score where smaller is
always better, so one code path serves all metrics:

    l2     : ||x||^2 - 2 q.x          (add ||q||^2 back only for reported values)
    dot    : -q.x
    cosine : -q_hat.x_hat             (vectors normalized at ingest)

The reference returns squared (not rooted) distance (src/hnsw.zig:191); we keep
that contract for reported l2 values.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Optional

import jax
import jax.numpy as jnp

NEG_INF = -jnp.inf

# The one place the engines' precision names ("highest", "float32", "high",
# "default") become what XLA is asked for: (matmul `precision=` argument,
# jax.default_matmul_precision name). chip_smoke.py prints what "high"
# lowers to on the card.
#
# "high" is full f32 (Precision.HIGHEST). The engines were tuned for a
# ~1e-6-relative scoring matmul; on the GPU, Precision.HIGH runs as TF32
# (10-bit mantissa), and a single-query dot then takes another path than
# a batched one, so the same query's neighbours depended on the batch it
# rode in (60 of 256 CAGRA queries at 1M). The bf16x3 algorithm preset is
# not available to every dot on the CPU backend.
_MATMUL_PRECISION = {
    "highest": (jax.lax.Precision.HIGHEST, "highest"),
    "float32": (jax.lax.Precision.HIGHEST, "highest"),
    "high": (jax.lax.Precision.HIGHEST, "highest"),
    "default": (jax.lax.Precision.DEFAULT, None),
}


def matmul_precision(name: str):
    """The `precision=` argument for a matmul at engine precision `name`."""
    return _MATMUL_PRECISION[name][0]


def precision_context(name: str):
    """Context in which un-annotated matmuls run at engine precision `name`
    ("default" leaves the platform default in place)."""
    ctx = _MATMUL_PRECISION[name][1]
    if ctx is None:
        return contextlib.nullcontext()
    return jax.default_matmul_precision(ctx)


def sq_norms(x: jax.Array) -> jax.Array:
    """Squared L2 norms along the last axis, computed in f32."""
    xf = x.astype(jnp.float32)
    return jnp.sum(xf * xf, axis=-1)


def normalize(x: jax.Array, eps: float = 1e-12) -> jax.Array:
    """L2-normalize along the last axis (cosine metric ingest path)."""
    xf = x.astype(jnp.float32)
    n = jnp.sqrt(jnp.sum(xf * xf, axis=-1, keepdims=True))
    return (xf / jnp.maximum(n, eps)).astype(x.dtype)


def preprocess_corpus(x: jax.Array, metric: str, dtype=jnp.float32):
    """Returns (stored_vectors, stored_sq_norms) for a corpus under `metric`.

    For cosine the stored vectors are normalized so search is a plain dot product.
    Norms are kept in f32 regardless of storage dtype.
    """
    if metric == "cosine":
        x = normalize(x)
    stored = x.astype(dtype)
    norms = sq_norms(stored) if metric == "l2" else jnp.zeros(x.shape[:-1], jnp.float32)
    return stored, norms


def quantize_corpus_global(x: jax.Array, metric: str, scale: jax.Array):
    """Per-TENSOR symmetric int8 quantization with a fixed scale (the graph
    engine's storage path — per-vector scales would cost one extra row gather
    per search hop). Returns (codes int8, sq_norms f32).

    Norms are of the DEQUANTIZED codes (scale*codes), not the originals, so
    search scores norms - 2*scale*(q.codes) are the EXACT squared distances to
    the stored (dequantized) points — the engine is an exact search over its
    stored data, with quantization loss confined to the representation."""
    xf = x.astype(jnp.float32)
    if metric == "cosine":
        xf = normalize(xf)
    codes = jnp.clip(jnp.round(xf / scale), -127, 127).astype(jnp.int8)
    if metric == "l2":
        norms = scale * scale * sq_norms(codes.astype(jnp.float32))
    else:
        norms = jnp.zeros(xf.shape[:-1], jnp.float32)
    return codes, norms


def quantize_corpus(x: jax.Array, metric: str, bits: int = 8):
    """Symmetric per-vector integer quantization (the idiomatic analog of the
    reference's integer HNSW instantiation, src/test_hnsw.zig:239-273).

    bits=8 -> int8 codes (levels +-127); bits=16 -> int16 (+-32767, ~128x
    finer — the PQ refine store's exact-rescore grade at 2 bytes/dim).
    Returns (codes int [..., D], scales f32 [...], sq_norms f32 [...]).
    Reconstruction: x_i ~= scales_i * codes_i; norms are exact (from f32).
    """
    lim, dtype = {8: (127.0, jnp.int8), 16: (32767.0, jnp.int16)}[bits]
    xf = x.astype(jnp.float32)
    if metric == "cosine":
        xf = normalize(xf)
    amax = jnp.max(jnp.abs(xf), axis=-1)
    scales = jnp.maximum(amax, 1e-12) / lim
    codes = jnp.clip(jnp.round(xf / scales[..., None]), -lim, lim).astype(dtype)
    norms = sq_norms(xf) if metric == "l2" else jnp.zeros(xf.shape[:-1], jnp.float32)
    return codes, scales, norms


def preprocess_queries(q: jax.Array, metric: str, compute_dtype=jnp.float32) -> jax.Array:
    if metric == "cosine":
        q = normalize(q)
    return q.astype(compute_dtype)


def pairwise_scores(
    q: jax.Array, x: jax.Array, x_norms: jax.Array, metric: str, precision=None,
    x_scales: Optional[jax.Array] = None,
) -> jax.Array:
    """Surrogate scores between query batch [B, D] and corpus [N, D] -> [B, N].

    Smaller is better for every metric. One [B,D]x[D,N] matmul — the hot
    path for flat search and ground truth. `precision`: pass
    matmul_precision("highest") for exact oracles (f32 matmuls may otherwise
    run at reduced precision); leave None for the fast search path.
    """
    dots = jnp.dot(
        q.astype(jnp.float32),
        x.T.astype(jnp.float32),
        preferred_element_type=jnp.float32,
        precision=precision,
    )
    if x_scales is not None:  # int8 codes: dequantize the dot product
        dots = dots * x_scales[None, :]
    if metric == "l2":
        return x_norms[None, :] - 2.0 * dots
    # dot and cosine (cosine vectors pre-normalized): x_norms acts as an
    # additive validity bias (0 for live rows, +inf for padding) so callers
    # never need a separate [B, N] mask
    return x_norms[None, :] - dots


def gathered_scores(
    q: jax.Array, cand_vecs: jax.Array, cand_norms: jax.Array, metric: str,
    precision=None, scale=None,
) -> jax.Array:
    """Scores between queries [B, D] and per-query candidates [B, C, D] -> [B, C].

    The graph-search hot path: one batched matvec (einsum over D).
    `scale`: per-tensor dequant scalar for int8 candidate codes (x ~= scale*codes);
    applied to the dot products only — norms are stored exact.
    """
    dots = jnp.einsum(
        "bd,bcd->bc",
        q.astype(jnp.float32),
        cand_vecs.astype(jnp.float32),
        preferred_element_type=jnp.float32,
        precision=precision,
    )
    if scale is not None:
        dots = dots * scale
    if metric == "l2":
        return cand_norms - 2.0 * dots
    return -dots


def finalize_scores(scores: jax.Array, q: jax.Array, metric: str) -> jax.Array:
    """Convert surrogate scores to user-facing values.

    l2 -> squared L2 distance (reference contract, src/hnsw.zig:191)
    dot/cosine -> similarity (higher is better), i.e. negated surrogate.
    """
    if metric == "l2":
        return scores + sq_norms(q)[..., None]
    return -scores


@functools.partial(jax.jit, static_argnames=("metric",))
def brute_force_scores(q: jax.Array, x: jax.Array, metric: str) -> jax.Array:
    """Convenience: full [B, N] user-facing scores (testing / tiny corpora)."""
    if metric == "cosine":
        q = normalize(q)
        x = normalize(x)
    norms = sq_norms(x) if metric == "l2" else jnp.zeros(x.shape[0], jnp.float32)
    s = pairwise_scores(q.astype(jnp.float32), x, norms, metric)
    return finalize_scores(s, q, metric)
