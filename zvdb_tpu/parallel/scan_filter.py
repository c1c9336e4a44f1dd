"""Sharded masked exact scan — the filtered-search fallback for the
sharded graph/IVF engines.

Round-4 measured policy (docs/PERF.md "filtered search + deletes at
scale"): candidate-pool filtering collapses on selective filters (CAGRA
beam 0.358 recall @ 1% selectivity at ef=1200; IVF probes 0.256 at 8x
widening) while a masked brute-force scan is EXACT at every selectivity
and faster even at 50%. The single-chip engines route `allowed=` through
flat.masked_exact_search; this is the shard_map form: per-shard masked
scan + per-shard top-k inside the mesh, one all-gather of [B, S*k]
candidates, global exact merge — identical comm shape to ShardedFlat's
normal search path.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..ops import distance as D
from ..ops import topk as T
from .mesh import DATA_AXIS, SHARD_AXIS, shard_map

INF = jnp.inf


def make_sharded_masked_scan(mesh, n_data: int, metric: str, precision: str,
                             k: int):
    """Build the jitted scan: (vectors [S, cap, D], norms_bias [S, cap],
    scales [S, cap], ext_ids [S, cap], q) -> (user scores [B, k], global
    ids [B, k]). norms_bias carries +inf for blocked/dead/padding rows
    (the all-metric validity-bias convention); ext_ids < 0 rows never
    surface. All shard-axis inputs are P(SHARD_AXIS)-sharded; queries ride
    the data axis when the mesh has one."""
    prec = D.matmul_precision(precision)
    qspec = P(DATA_AXIS) if n_data > 1 else P()
    ospec = P(DATA_AXIS if n_data > 1 else None, SHARD_AXIS)

    @jax.jit
    def run(vectors, norms_bias, scales, ext_ids, q):
        def local(v, nn, sc, ii, q):
            v, nn, sc, ii = v[0], nn[0], sc[0], ii[0]
            qp = D.preprocess_queries(q, metric)
            s = D.pairwise_scores(qp, v, nn, metric, precision=prec,
                                  x_scales=sc)
            s = jnp.where(ii[None, :] >= 0, s, INF)
            kk = min(k, s.shape[-1])
            ts, ti = T.smallest_k(s, jnp.broadcast_to(ii[None, :], s.shape),
                                  kk)
            ti = jnp.where(jnp.isfinite(ts), ti, -1)
            if kk < k:
                ts = jnp.pad(ts, ((0, 0), (0, k - kk)), constant_values=INF)
                ti = jnp.pad(ti, ((0, 0), (0, k - kk)), constant_values=-1)
            return ts[:, None, :], ti[:, None, :]

        ts, ti = shard_map(
            local, mesh=mesh,
            in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
                      P(SHARD_AXIS), qspec),
            out_specs=(ospec, ospec),
        )(vectors, norms_bias, scales, ext_ids, q)
        b = ts.shape[0]
        ms, mi = T.smallest_k(ts.reshape(b, -1), ti.reshape(b, -1), k)
        user = D.finalize_scores(ms, D.preprocess_queries(q, metric), metric)
        user = jnp.where(mi >= 0, user, INF if metric == "l2" else -INF)
        return user, mi

    return run
