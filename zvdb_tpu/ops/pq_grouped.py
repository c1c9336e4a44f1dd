"""Cluster-grouped ADC scan for IVF-PQ, twice: `pq_grouped_scan_bins` in
plain jnp/lax for XLA (the reference), and `pq_grouped_scan_bins_fused`, the
same contract as one Pallas kernel on the Triton route, which the engines
call (2.7x faster alone, 1.9x the search step at the 1M bench config on an
H100 — PERF.md).

(query, cluster) probe pairs are slotted per cluster before this call
(ivfpq._slot_pairs). Each cluster's nibble-packed code block is decoded once
to a one-hot [S*16, cap] operand and scored against the <= qcap queries that
probed it by one batched LUT matmul, so the total work is qcap x (C x cap),
about slack x P/C of a flat scan over all B x N pairs.

Scores then fold into per-query bins: row position r of a cluster belongs to
bin r % l_bins, and each bin keeps its best (per_bin=1) or best two
(per_bin=2) rows. The caller runs one small top-k over the pooled bins.

The plain version processes clusters in groups sized so that the one-hot
and score intermediates of one group stay under a fixed byte budget.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from . import topk as T
from .flat_scan import fold_init, fold_step, next_pow2

# Bytes of one-hot and score intermediates per cluster group.
_GROUP_BYTES = 1 << 28


def grouped_geometry(cap: int, l_bins: int, chunk: int) -> tuple[int, int]:
    """Effective (chunk, padded cap) for a cluster capacity: the cap pads to
    a multiple of chunk, and chunk shrinks to the smallest multiple of
    l_bins that covers cap. Callers need the padded cap to map the scan's
    within-cluster POSITIONS onto their own id tables."""
    chunk = min(chunk, -(-cap // l_bins) * l_bins)
    return chunk, -(-cap // chunk) * chunk


def lut_operands(lut: jax.Array, precision: str):
    """[B, S, 16] f32 ADC table -> (list of bf16 [B, S*16] matmul operands
    whose products sum to the scores, per-query scale [B]).

    "default": one bf16 pass. "high": hi/lo split, two bf16 passes (the
    one-hot side is exact in bf16, so only the table carries rounding).
    "int8": per-query symmetric quantization to integers in [-127, 127],
    exact in bf16; the sums over S are integers, exact in f32, and are
    rescaled by max|lut| / 127. The scale is floored so an all-zero row
    gives zeros, not NaN."""
    flat = lut.reshape(lut.shape[0], -1)
    if precision == "int8":
        scale = jnp.maximum(jnp.max(jnp.abs(flat), axis=1), 1e-30) / 127.0
        return [jnp.round(flat / scale[:, None]).astype(jnp.bfloat16)], scale
    ones = jnp.ones((flat.shape[0],), jnp.float32)
    hi = flat.astype(jnp.bfloat16)
    if precision == "high":
        lo = (flat - hi.astype(jnp.float32)).astype(jnp.bfloat16)
        return [hi, lo], ones
    return [hi], ones


@functools.partial(
    jax.jit,
    static_argnames=("l_bins", "chunk", "metric", "precision", "per_bin"),
)
def pq_grouped_scan_bins(
    lut: jax.Array,            # [B, S, 16] f32 ADC table (adc_lut, rotated qs)
    qslot: jax.Array,          # [C, qcap] int32 query slots per cluster; -1 empty
    codes_blocks: jax.Array,   # [C, S//2, cap] uint8 nibble-packed, per-cluster
    norms_blocks: jax.Array,   # [C, cap] f32 decoded sq-norms; +inf invalid
    l_bins: int = 128,
    chunk: int = 512,
    metric: str = "l2",
    precision: str = "default",
    per_bin: int = 2,
):
    """Grouped ADC scan + bin fold over every cluster's probing queries.

    Returns (bin_scores [C, qcap, per_bin*l_bins] f32 surrogates,
    bin_pos [C, qcap, per_bin*l_bins] int32 POSITIONS within the cluster's
    padded cap; the caller maps positions to ids via its b_ids table).
    With per_bin=2 the first l_bins columns hold each bin's best row and
    the next l_bins its runner-up. Empty slots (qslot < 0) come back
    +inf / -1. Surrogates: l2 = ||xhat||^2 - 2 q.xhat (query norm not
    added), dot/cosine = -q.xhat.
    """
    assert per_bin in (1, 2)
    assert precision in ("default", "high", "int8")
    b, n_sub, c16 = lut.shape
    assert c16 == 16, "the grouped scan requires n_codes <= 16 (nibble codes)"
    c, nb, cap = codes_blocks.shape
    assert nb * 2 == n_sub
    assert chunk % l_bins == 0, "chunk must be a multiple of l_bins"
    qcap = qslot.shape[1]
    _, capp = grouped_geometry(cap, l_bins, chunk)

    ops, scale = lut_operands(lut, precision)
    codes_p = jnp.pad(codes_blocks, ((0, 0), (0, 0), (0, capp - cap)))
    norms_p = jnp.pad(norms_blocks.astype(jnp.float32),
                      ((0, 0), (0, capp - cap)), constant_values=jnp.inf)
    factor = 2.0 if metric == "l2" else 1.0
    codes16 = jnp.arange(16, dtype=jnp.uint8)

    def one_cluster(args):
        slots, codes, norms = args            # [qcap], [nb, capp], [capp]
        safe = jnp.maximum(slots, 0)
        # byte j holds subspace 2j (low nibble) and 2j+1 (high nibble)
        sub = jnp.stack([codes & 0xF, codes >> 4], axis=1)   # [nb, 2, capp]
        onehot = (sub[:, :, None, :] == codes16[:, None]).astype(
            jnp.bfloat16).reshape(n_sub * 16, capp)
        dots = sum(jnp.dot(jnp.take(op, safe, axis=0), onehot,
                           preferred_element_type=jnp.float32)
                   for op in ops)                          # [qcap, capp]
        s = norms[None, :] - factor * dots * jnp.take(scale, safe)[:, None]
        s = jnp.where((slots >= 0)[:, None], s, jnp.inf)
        return T.bin_fold(s, l_bins, per_bin)

    per_cluster = capp * (n_sub * 16 * 2 + qcap * 4 * 3)
    group = max(1, min(c, _GROUP_BYTES // per_cluster))
    return jax.lax.map(one_cluster, (qslot, codes_p, norms_p),
                       batch_size=group)


# ---------------------------------------------------------------------------
# the same contract as one Pallas kernel on the Triton route


def _grouped_kernel(lut_ref, scale_ref, codes_ref, n_ref, out_s_ref,
                    out_i_ref, *, l_bins: int, lc: int, per_bin: int,
                    factor: float, n_ops: int):
    """One program = one cluster. The [qcap, nb*16] low- and high-nibble
    LUT halves stay in registers; the loop walks the cluster's rows in
    [nb, lc] code tiles, decodes each to a one-hot [nb*16, lc] operand in
    registers and scores it with tensor-core dots. Bin window w (lanes
    w*lc..) is folded over every group g of l_bins rows before it is
    written, so each code tile is read once."""
    qcap = lut_ref.shape[1]
    nb = codes_ref.shape[0]
    capp = codes_ref.shape[1]
    luts = [lut_ref[j] for j in range(2 * n_ops)]       # [qcap, nb*16] each
    scale = scale_ref[...][:, None]
    code_id = jax.lax.broadcasted_iota(jnp.int32, (nb, 16, lc), 1)
    lane = jax.lax.broadcasted_iota(jnp.int32, (qcap, lc), 1)

    def onehot(nib):                                     # [nb, lc] int32
        hit = nib[:, None, :] == code_id
        return jnp.where(hit, 1.0, 0.0).astype(jnp.bfloat16).reshape(
            nb * 16, lc)

    for w in range(l_bins // lc):
        def body(g, carry, w=w):
            col0 = g * l_bins + w * lc
            cols = pl.ds(col0, lc)
            c = codes_ref[:, cols].astype(jnp.int32)
            lo, hi = onehot(c & 0xF), onehot(c >> 4)
            dots = pl.dot(luts[0], lo) + pl.dot(luts[1], hi)
            for o in range(1, n_ops):
                dots = dots + pl.dot(luts[2 * o], lo) + pl.dot(
                    luts[2 * o + 1], hi)
            s = n_ref[cols][None, :] - factor * (dots * scale)
            return fold_step(carry, s, col0 + lane)

        cur = jax.lax.fori_loop(0, capp // l_bins, body,
                                fold_init((qcap, lc), per_bin))
        for r in range(per_bin):
            out_s_ref[:, pl.ds(r * l_bins + w * lc, lc)] = cur[2 * r]
            out_i_ref[:, pl.ds(r * l_bins + w * lc, lc)] = cur[2 * r + 1]


@functools.partial(
    jax.jit,
    static_argnames=("l_bins", "chunk", "metric", "precision", "per_bin",
                     "num_warps", "num_stages", "interpret"),
)
def pq_grouped_scan_bins_fused(
    lut, qslot, codes_blocks, norms_blocks, l_bins: int = 128,
    chunk: int = 512, metric: str = "l2", precision: str = "default",
    per_bin: int = 2, num_warps: int = 4, num_stages: int = 2,
    interpret: bool = False,
):
    """pq_grouped_scan_bins as one fused kernel: same inputs, same outputs
    up to f32 rounding order. qcap must be a power of two >= 16 (the
    tensor-core dot's minimum) and l_bins a power of two."""
    assert per_bin in (1, 2)
    assert precision in ("default", "high", "int8")
    b, n_sub, c16 = lut.shape
    assert c16 == 16, "the grouped scan requires n_codes <= 16 (nibble codes)"
    c, nb, cap = codes_blocks.shape
    assert nb * 2 == n_sub
    assert chunk % l_bins == 0, "chunk must be a multiple of l_bins"
    assert l_bins == next_pow2(l_bins) and l_bins >= 16
    qcap = qslot.shape[1]
    assert qcap >= 16 and qcap == next_pow2(qcap), "qcap: a power of two >= 16"
    _, capp = grouped_geometry(cap, l_bins, chunk)
    nbp = next_pow2(nb)              # Triton block dims are powers of two

    ops, scale = lut_operands(lut, precision)
    safe = jnp.maximum(qslot, 0)
    halves = []
    for op in ops:                   # [B, S*16] -> even / odd subspaces
        op = op.reshape(b, nb, 2, 16)
        for nib in range(2):
            half = jnp.pad(op[:, :, nib, :], ((0, 0), (0, nbp - nb), (0, 0)))
            halves.append(jnp.take(half.reshape(b, nbp * 16), safe, axis=0))
    lut_s = jnp.stack(halves)                        # [2*n_ops, C, qcap, nbp*16]
    scale_s = jnp.take(scale, safe)                  # [C, qcap]
    codes_p = jnp.pad(codes_blocks, ((0, 0), (0, nbp - nb), (0, capp - cap)))
    norms_p = jnp.pad(norms_blocks.astype(jnp.float32),
                      ((0, 0), (0, capp - cap)), constant_values=jnp.inf)

    lc = min(32, l_bins)
    width = per_bin * l_bins
    kernel = functools.partial(
        _grouped_kernel, l_bins=l_bins, lc=lc, per_bin=per_bin,
        factor=2.0 if metric == "l2" else 1.0, n_ops=len(ops))
    bin_s, bin_p = pl.pallas_call(
        kernel,
        grid=(c,),
        in_specs=[
            pl.BlockSpec((len(halves), None, qcap, nbp * 16),
                         lambda i: (0, i, 0, 0)),
            pl.BlockSpec((None, qcap), lambda i: (i, 0)),
            pl.BlockSpec((None, nbp, capp), lambda i: (i, 0, 0)),
            pl.BlockSpec((None, capp), lambda i: (i, 0)),
        ],
        out_specs=[
            pl.BlockSpec((None, qcap, width), lambda i: (i, 0, 0)),
            pl.BlockSpec((None, qcap, width), lambda i: (i, 0, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((c, qcap, width), jnp.float32),
            jax.ShapeDtypeStruct((c, qcap, width), jnp.int32),
        ],
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=num_warps, num_stages=num_stages),
        interpret=interpret,
        name="pq_grouped_scan_bins",
    )(lut_s, scale_s, codes_p, norms_p)
    live = (qslot >= 0)[:, :, None]
    return (jnp.where(live, bin_s, jnp.inf),
            jnp.where(live, bin_p, -1))

