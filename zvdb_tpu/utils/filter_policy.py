"""Auto filter-mode routing: masked exact scan vs beam/probe by regime.

The reference has no filtered search at all. This policy module routes
between the exact masked scan, which holds recall at every selectivity
(graph beams collapse on selective filters), and the sublinear beam/probe
path, which can win only in the near-all-pass regime on very large corpora,
where filtering is almost a no-op.

``filter_mode="auto"`` (the engine default) routes per call:

    scan   unless  n >= N_CROSSOVER  and  selectivity >= SEL_NEAR_ALL

Cost discipline: the corpus-size gate is checked FIRST, so below the
crossover no selectivity estimate (and no device sync) ever happens. Above
it, a boolean device mask costs one scalar pull (amortized over the query
batch); host numpy masks and id allowlists are free.

The two constants come from no measurement: they are placeholders until a
selectivity x N grid on the H100 prices the crossover (ROADMAP 2.7).
"""
from __future__ import annotations

import numpy as np

# Crossover constants (unmeasured placeholders, see the module docstring).
N_CROSSOVER: int = 4_000_000
SEL_NEAR_ALL: float = 0.90


def mask_selectivity(allowed, n: int) -> float:
    """Fraction of the n live ids the allowlist passes (estimate in [0, 1]).

    allowed: bool mask over ids (host or device) or an int id array.
    Host inputs are free; a device bool mask costs one scalar sync
    (jnp.mean pulled as float) — never a full-mask transfer.
    """
    if n <= 0:
        return 1.0
    if isinstance(allowed, (list, tuple)):
        allowed = np.asarray(allowed)
    if isinstance(allowed, np.ndarray):
        if allowed.dtype == np.bool_:
            m = allowed[:n]
            return float(m.mean()) if m.size else 1.0
        return min(1.0, allowed.size / n)
    # jax array (or anything array-like on device)
    import jax.numpy as jnp

    a = jnp.asarray(allowed)
    if a.dtype == jnp.bool_:
        if a.shape[0] == 0:
            return 1.0
        return float(jnp.mean(a[:n].astype(jnp.float32)))
    return min(1.0, int(np.prod(a.shape)) / n)


def resolve_filter_mode(filter_mode: str, allowed, n: int,
                        alt: str = "beam") -> str:
    """Resolve "auto" to "scan" or the engine's sublinear mode (alt).

    alt is "beam" for the graph engines, "probe" for IVF/IVF-PQ. Explicit
    modes pass through unchanged; callers validate membership themselves.
    """
    if filter_mode != "auto":
        return filter_mode
    if allowed is None or n < N_CROSSOVER:
        return "scan"
    if mask_selectivity(allowed, n) >= SEL_NEAR_ALL:
        return alt
    return "scan"
