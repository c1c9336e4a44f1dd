"""Product quantization (PQ) ops: train / encode / decode, all in matmul form.

The memory lever the int8 path can't reach: int8 stores D bytes/vector (128 B
at 128d), PQ stores n_sub bytes/vector (16 B at n_sub=16) — 8x smaller, which
is what makes 100M-vector configurations fit on one card (BASELINE config 5:
100M x 16 B = 1.6 GB of codes vs 12.8 GB int8 / 51.2 GB f32).

Matmul formulation — the classical ADC scan is a per-row LUT gather, and
row gathers are the expensive operation on an accelerator. Instead every
step here is a matmul:

  train : per-subspace Lloyd, vmapped over subspaces — assignment is a
          [m, C] distance matmul + argmin, the centroid update is the
          one-hot-matmul trick (onehot^T @ x), identical in spirit to the
          IVF k-means (index/ivf.py).
  encode: per-subspace nearest-centroid assignment, tiled with lax.scan so
          the [chunk, S, C] distance block stays bounded.
  decode: onehot(codes) @ codebooks per subspace — one [T, C] x [C, dsub]
          matmul per subspace instead of T gathers. Decode FLOPs are
          T*C*D regardless of batch, so against a [B, T] scoring matmul
          (B*D*T FLOPs) decode adds only C/B overhead (~3% at B=8192).

Scoring is asymmetric (ADC): exact f32 queries against decoded (quantized)
corpus rows, the standard recall-preserving choice. No reference counterpart
(the reference stores raw f32 only, src/hnsw.zig:24-26); this extends the
"Different Data Types" capability axis (src/test_hnsw.zig:239-273) the same
way the int8 path does.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import distance as D


@functools.partial(jax.jit, static_argnames=("n_sub", "n_codes", "iters"))
def train_codebooks(
    xs: jax.Array, key: jax.Array, n_sub: int, n_codes: int, iters: int,
) -> jax.Array:
    """Per-subspace k-means codebooks from a training sample.

    xs: [m, D] f32 sample (already metric-preprocessed: normalized for
    cosine). Returns codebooks [n_sub, n_codes, D // n_sub] f32.

    All subspaces run one vmapped Lloyd loop: assignment is a distance
    matmul + argmin, the update is onehot^T @ x — pure matmul work, no host
    round-trips. Empty clusters keep their previous centroid (same policy
    as the IVF k-means).
    """
    m, d = xs.shape
    dsub = d // n_sub
    x_s = xs.reshape(m, n_sub, dsub).transpose(1, 0, 2)  # [S, m, dsub]

    # independent init per subspace: distinct centroid draws
    keys = jax.random.split(key, n_sub)
    init_sel = jax.vmap(
        lambda k: jax.random.choice(k, m, (n_codes,), replace=m < n_codes)
    )(keys)                                              # [S, C]
    cent = jnp.take_along_axis(x_s, init_sel[:, :, None], axis=1)  # [S, C, dsub]

    def lloyd(cent, _):
        cn = jnp.sum(cent * cent, axis=-1)               # [S, C]
        dots = jnp.einsum("smd,scd->smc", x_s, cent,
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
        a = jnp.argmin(cn[:, None, :] - 2.0 * dots, axis=-1)   # [S, m]
        oh = jax.nn.one_hot(a, n_codes, dtype=jnp.float32)     # [S, m, C]
        sums = jnp.einsum("smc,smd->scd", oh, x_s,
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
        cnt = oh.sum(axis=1)                             # [S, C]
        new = sums / jnp.maximum(cnt, 1.0)[..., None]
        return jnp.where((cnt > 0)[..., None], new, cent), None

    cent, _ = jax.lax.scan(lloyd, cent, None, length=iters)
    return cent


@functools.partial(
    jax.jit, static_argnames=("n_sub", "n_codes", "iters", "opq_iters")
)
def train_opq(
    xs: jax.Array, key: jax.Array, n_sub: int, n_codes: int, iters: int,
    opq_iters: int,
) -> tuple[jax.Array, jax.Array]:
    """Optimized PQ (OPQ): learn an orthogonal rotation R that minimizes
    quantization error before the subspace split, alternating Lloyd codebook
    updates with an orthogonal-Procrustes rotation solve (the non-parametric
    OPQ scheme — PAPERS.md quantization line; no reference counterpart).

    xs: [m, D] f32 metric-preprocessed sample. Returns (rot [D, D] f32,
    codebooks [n_sub, n_codes, D//n_sub] f32) where codebooks quantize x@rot.

    Rotation init is a random orthogonal matrix (QR of a Gaussian): identity
    init can start at a coordinate-aligned local minimum on axis-correlated
    data, and the alternation recovers natural structure either way. Every
    step is matmul work except the [D, D] SVD, which is negligible at D<=1024.
    The whole alternation is one jitted program (one remote compile).
    """
    m, d = xs.shape
    k_init, k_cb = jax.random.split(key)
    g = jax.random.normal(k_init, (d, d), jnp.float32)
    rot, _ = jnp.linalg.qr(g)

    def step(rot, _):
        xr = jnp.einsum("md,de->me", xs, rot,
                        preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)
        # few Lloyd iters per alternation: codebooks only need to track the
        # rotation, the final full training below polishes them
        cb = train_codebooks(xr, k_cb, n_sub, n_codes, iters=4)
        codes = encode(xr, cb)
        xhat = decode(codes, cb)
        # orthogonal Procrustes: argmin_R ||X R - Xhat||_F over orthogonal R
        # is R = U V^T with X^T Xhat = U S V^T
        mm = jnp.einsum("md,me->de", xs, xhat,
                        preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)
        u, _, vt = jnp.linalg.svd(mm, full_matrices=False)
        return u @ vt, None

    rot, _ = jax.lax.scan(step, rot, None, length=opq_iters)
    xr = jnp.einsum("md,de->me", xs, rot,
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    return rot, train_codebooks(xr, k_cb, n_sub, n_codes, iters)


def apply_rotation(x: jax.Array, rot: jax.Array) -> jax.Array:
    """x @ rot when a rotation is present ([D, D]); identity when the
    sentinel empty [0, 0] rotation is passed (plain PQ). Shape test is
    trace-time static, so jitted callers stay branch-free."""
    if rot.shape[0] == 0:
        return x
    return jnp.einsum("...d,de->...e", x, rot,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)


@functools.partial(jax.jit, static_argnames=("chunk",))
def encode(x: jax.Array, codebooks: jax.Array, chunk: int = 16384) -> jax.Array:
    """Nearest-centroid codes per subspace: [B, D] f32 -> [B, S] uint8.

    Tiled with lax.scan so the [chunk, S, C] distance block stays bounded
    (a one-shot encode of 1M rows would materialize a 16 GB intermediate).
    """
    b, d = x.shape
    n_sub, n_codes, dsub = codebooks.shape
    chunk = min(chunk, max(b, 1))
    n_chunks = -(-b // chunk) if b else 1
    pad = n_chunks * chunk - b
    xp = jnp.pad(x, ((0, pad), (0, 0))).reshape(n_chunks, chunk, n_sub, dsub)
    cn = jnp.sum(codebooks * codebooks, axis=-1)         # [S, C]

    def body(_, xt):                                     # xt [chunk, S, dsub]
        dots = jnp.einsum("tsd,scd->tsc", xt, codebooks,
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
        a = jnp.argmin(cn[None] - 2.0 * dots, axis=-1)   # [chunk, S]
        return None, a.astype(jnp.uint8)

    _, codes = jax.lax.scan(body, None, xp)
    return codes.reshape(n_chunks * chunk, n_sub)[:b]


def decode(codes: jax.Array, codebooks: jax.Array) -> jax.Array:
    """Reconstruct rows: [T, S] uint8 codes -> [T, D] f32.

    One-hot matmul per subspace (einsum over the code axis) — the gather-free
    decode. 0/1 one-hot entries are exact in any dtype; the codebook stays
    f32 so decoded values match the norms computed at encode time bit-for-bit
    (l2 scoring depends on that consistency).
    """
    t = codes.shape[0]
    n_sub, n_codes, dsub = codebooks.shape
    oh = jax.nn.one_hot(codes, n_codes, dtype=jnp.float32)  # [T, S, C]
    out = jnp.einsum("tsc,scd->tsd", oh, codebooks,
                     preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    return out.reshape(t, n_sub * dsub)


def pack_nibbles(codes: jax.Array) -> jax.Array:
    """[B, S] uint8 codes (< 16) -> [B, S//2] packed bytes.

    Byte j holds subspace 2j in the LOW nibble and 2j+1 in the HIGH nibble
    (the layout ops/pq_grouped.py's one-hot decode assumes). S must be
    even. 4-bit codes halve PQ storage (16 B/vector at n_sub=32), and 16
    one-hot columns per subspace keep the ADC matmul width at S*16 instead
    of S*256.
    """
    lo = codes[:, 0::2].astype(jnp.uint8)
    hi = codes[:, 1::2].astype(jnp.uint8)
    return lo | (hi << 4)


def unpack_nibbles(packed: jax.Array, n_sub: int) -> jax.Array:
    """[B, S//2] packed bytes -> [B, S] uint8 codes (inverse of pack_nibbles)."""
    lo = packed & 0xF
    hi = packed >> 4
    out = jnp.stack([lo, hi], axis=-1)          # [B, S//2, 2]
    return out.reshape(*packed.shape[:-1], n_sub)


def adc_lut(q: jax.Array, codebooks: jax.Array) -> jax.Array:
    """Per-query ADC dot-product table: [B, D] queries (already rotated for
    OPQ) x [S, C, dsub] codebooks -> [B, S, C] f32 with
    lut[b, s, c] = q_s[b] . codebook[s, c].

    The asymmetric-distance scan is then scores[b, t] = sum_s
    lut[b, s, codes[t, s]] (times -2 plus norms for l2). Tiny matmul work
    (B*C*D FLOPs once per query batch) — the per-corpus-row cost lives in
    the scan kernel.
    """
    b, d = q.shape
    n_sub, n_codes, dsub = codebooks.shape
    qs = q.reshape(b, n_sub, dsub)
    return jnp.einsum("bsd,scd->bsc", qs, codebooks,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)


@functools.partial(jax.jit, static_argnames=("chunk",))
def decoded_sq_norms(codes: jax.Array, codebooks: jax.Array,
                     chunk: int = 16384) -> jax.Array:
    """||decode(codes)||^2 per row, tiled: [B, S] -> [B] f32.

    Cheaper than a full decode: per-subspace squared centroid norms are a
    [C]-table lookup done as a one-hot matvec, and subspace norms add
    (subspaces are disjoint coordinate blocks).
    """
    b = codes.shape[0]
    n_sub, n_codes, _ = codebooks.shape
    cn = jnp.sum(codebooks * codebooks, axis=-1)         # [S, C]
    chunk = min(chunk, max(b, 1))
    n_chunks = -(-b // chunk) if b else 1
    pad = n_chunks * chunk - b
    cp = jnp.pad(codes, ((0, pad), (0, 0))).reshape(n_chunks, chunk, n_sub)

    def body(_, ct):                                     # ct [chunk, S]
        oh = jax.nn.one_hot(ct, n_codes, dtype=jnp.float32)   # [chunk, S, C]
        return None, jnp.einsum("tsc,sc->t", oh, cn,
                                preferred_element_type=jnp.float32,
                                precision=jax.lax.Precision.HIGHEST)

    _, norms = jax.lax.scan(body, None, cp)
    return norms.reshape(n_chunks * chunk)[:b]
