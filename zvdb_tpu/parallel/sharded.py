"""Sharded index: corpus partitioned over a device mesh, per-shard graphs,
query fan-out, all-gather top-k merge (BASELINE.json config 5; SURVEY.md §2.3).

Design (scaling-book recipe):
  * The corpus axis N is partitioned into S shards — the expert-parallel analog
    for a vector DB (each shard ≈ an expert; every query visits all shards).
  * Each shard holds an independent HNSW graph over its subset; graph gathers
    never cross shards, so per-shard search runs under `shard_map` with zero
    communication.
  * Per-shard top-k results (global external ids) are merged by a plain jnp
    top-k over the gathered [B, S*k] matrix — XLA inserts the all-gather
    between devices automatically from the sharding annotations.
  * The query batch can additionally be sharded over a `data` mesh axis (DP).
  * Bulk build runs the same batched build step on every shard simultaneously
    (each device extends its own subgraph with its own slice — SPMD, no locks;
    contrast reference src/hnsw.zig:74: one global mutex).
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..index.build import build_batch_impl, sample_levels
from ..index.hnsw import HNSWState, init_state, max_level_for, search_state_impl
from ..ops import distance as D
from ..ops import topk as T
from ..utils.config import HNSWConfig, SearchConfig
from .mesh import DATA_AXIS, SHARD_AXIS, make_mesh, shard_map

def _state_specs(state: HNSWState) -> HNSWState:
    """PartitionSpec pytree: every leaf carries a leading shard axis."""
    return jax.tree.map(lambda _: P(SHARD_AXIS), state)


def _strip(stacked: HNSWState) -> HNSWState:
    return jax.tree.map(lambda a: a[0], stacked)


def _stack1(state: HNSWState) -> HNSWState:
    return jax.tree.map(lambda a: a[None], state)


def make_anchor_reseed(mesh: Mesh, a_count: int):
    """Jitted shard_map'd anchor (re)sampler for any stacked engine state
    carrying vectors/norms/q_scale/n + anchors/a_norms/a_rows fields.

    Resamples `a_count` anchor rows per shard over that shard's live range
    [0, n) — shape-stable (with replacement), so grown indexes refresh their
    seed tables without recompiling anything but this function. Also serves
    as the initial attach for builds whose step has no anchor epilogue."""

    @jax.jit
    def reseed(state, key):
        specs = jax.tree.map(lambda _: P(SHARD_AXIS), state)
        out_specs = jax.tree.map(lambda _: P(SHARD_AXIS), state)

        def local(st, key):
            st1 = jax.tree.map(lambda a: a[0], st)
            k = jax.random.fold_in(key, jax.lax.axis_index(SHARD_AXIS))
            rows = jax.random.randint(
                k, (a_count,), 0, jnp.maximum(st1.n, 1), jnp.int32)
            anchors = jnp.take(st1.vectors, rows, axis=0) \
                .astype(jnp.float32) * st1.q_scale
            st1 = st1._replace(anchors=anchors,
                               a_norms=jnp.take(st1.norms, rows),
                               a_rows=rows)
            return jax.tree.map(lambda a: a[None], st1)

        return shard_map(local, mesh=mesh, in_specs=(specs, P()),
                         out_specs=out_specs)(state, key)

    return reseed


class ShardedHNSW:
    """Mesh-sharded HNSW. API mirrors the single-chip class (build/search/len)."""

    def __init__(
        self,
        cfg: HNSWConfig,
        search_cfg: SearchConfig = SearchConfig(),
        mesh: Optional[Mesh] = None,
        seed: int = 0,
    ):
        self.cfg = cfg
        self.search_cfg = search_cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_shards = self.mesh.shape[SHARD_AXIS]
        self.n_data = self.mesh.shape.get(DATA_AXIS, 1)
        self.state: Optional[HNSWState] = None  # stacked: leading shard axis
        self.levels_cap = 1
        self.shard_cap = 0
        self._key = jax.random.PRNGKey(seed)
        self._n = 0
        self._search_fn = None
        self._pending: list[np.ndarray] = []
        self._step_fns = {}
        self._reseed_fn = None
        self._reseed_key = None
        self._anchor_n = 0   # max per-shard n at the last anchor snapshot
        self._dead: set[int] = set()              # tombstoned global ids
        self._dead_mask: Optional[jax.Array] = None  # [S, cap+1] bool by row
        self._dead_placeholder: Optional[jax.Array] = None

    def __len__(self) -> int:
        return (self._n + sum(p.shape[0] for p in self._pending)
                - len(self._dead))

    def remove(self, ids) -> int:
        """Delete by global id (mark-and-filter; same contract as the
        single-chip engines — tombstoned nodes keep routing each shard's
        beam and are filtered from the beam before the per-shard top-k).
        Ids never renumber. Returns the number of rows newly deleted."""
        ids = np.unique(np.atleast_1d(np.asarray(ids, np.int64)))
        if ids.size == 0:
            return 0
        self._flush()
        if (ids < 0).any() or (ids >= self._n).any():
            raise IndexError(f"ids must be in [0, {self._n})")
        new = np.asarray(
            [int(i) for i in ids if int(i) not in self._dead], np.int64)
        if new.size == 0:
            return 0
        ext = np.asarray(self.state.ext_ids)   # [S, cap] global ids
        rr, cc = np.nonzero(np.isin(ext, new))
        self._sync_dead_mask()
        self._dead_mask = self._dead_mask.at[
            jnp.asarray(rr), jnp.asarray(cc)].set(True)
        self._dead.update(int(i) for i in new)
        self._search_fn = None
        return int(new.size)

    def compact(self) -> np.ndarray:
        """Drop tombstones; survivors renumber to [0, L) in former global-id
        order (one re-shard + rebuild). Returns the survivors' old ids."""
        self._flush()
        alive = np.ones(self._n, bool)
        if self._dead:
            alive[np.fromiter(self._dead, np.int64, len(self._dead))] = False
        live = np.flatnonzero(alive)
        if self.state is None or not self._dead:
            self._dead = set()
            return live
        ext = np.asarray(self.state.ext_ids)                 # [S, cap]
        vecs = np.asarray(self.state.vectors, np.float32)    # [S, cap, D]
        if self.cfg.dtype == "int8":
            vecs = vecs * np.asarray(self.state.q_scale)[:, None, None]
        x_all = np.empty((self._n, self.cfg.dim), np.float32)
        sel = ext >= 0
        x_all[ext[sel]] = vecs[sel]
        self.build(x_all[live])
        return live

    def _sync_dead_mask(self) -> None:
        cap1 = self.state.nbr0.shape[1]         # per-shard cap + trash row
        sh = NamedSharding(self.mesh, P(SHARD_AXIS))
        if self._dead_mask is None:
            self._dead_mask = jax.device_put(
                jnp.zeros((self.n_shards, cap1), bool), sh)
        elif self._dead_mask.shape[1] < cap1:
            grown = jnp.zeros((self.n_shards, cap1), bool)
            grown = grown.at[:, : self._dead_mask.shape[1]].set(
                self._dead_mask)
            self._dead_mask = jax.device_put(grown, sh)

    # ------------------------------------------------------------------ build
    def build(self, x) -> None:
        """Bulk-build: contiguous split of the corpus across shards, all shards
        built in parallel under shard_map."""
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        s = self.n_shards
        per = -(-n // s) if n else 1
        bsz = min(self.cfg.build_batch, per)
        per_pad = -(-per // bsz) * bsz
        self.shard_cap = per_pad
        self.levels_cap = (
            self.cfg.max_level
            if self.cfg.max_level is not None
            else max_level_for(per_pad, self.cfg.m)
        )
        self._n = n

        # host-side shard prep: slice, sample levels, level-desc sort, global ids
        xs = np.zeros((s, per_pad, self.cfg.dim), np.float32)
        ls = np.full((s, per_pad), -1, np.int32)
        es = np.full((s, per_pad), -1, np.int32)
        vs = np.zeros((s, per_pad), bool)
        self._key, sub = jax.random.split(self._key)
        all_levels = sample_levels(sub, n, self.cfg.m, self.levels_cap, self.cfg.ml)
        for si in range(s):
            lo, hi = si * per, min((si + 1) * per, n)
            cnt = max(hi - lo, 0)
            if cnt == 0:
                continue
            lv = all_levels[lo:hi]
            order = np.argsort(-lv, kind="stable")
            xs[si, :cnt] = x[lo:hi][order]
            ls[si, :cnt] = lv[order]
            es[si, :cnt] = (lo + order).astype(np.int32)
            vs[si, :cnt] = True

        mesh = self.mesh
        shard_sharding = NamedSharding(mesh, P(SHARD_AXIS))
        state = jax.jit(
            lambda: jax.tree.map(
                lambda a: jnp.broadcast_to(a[None], (s,) + a.shape),
                init_state(per_pad, self.cfg, self.levels_cap),
            ),
            out_shardings=jax.tree.map(lambda _: shard_sharding, _state_specs(
                init_state(0, self.cfg, self.levels_cap))),
        )()

        step = self._make_step()
        nb = per_pad // bsz
        for t in range(nb):
            lo, hi = t * bsz, (t + 1) * bsz
            state = step(
                state,
                jax.device_put(xs[:, lo:hi], shard_sharding),
                jax.device_put(ls[:, lo:hi], shard_sharding),
                jax.device_put(es[:, lo:hi], shard_sharding),
                jax.device_put(vs[:, lo:hi], shard_sharding),
            )
        self.state = state
        # anchor attach: the batched step has no anchor epilogue, so sharded
        # HNSW searches were descent-only seeded (anchors [0, D]) — attach a
        # per-shard table now (same routing win as the single-chip engine)
        self._attach_anchors(per)
        self._search_fn = None
        self._pending = []
        self._dead = set()
        self._dead_mask = None

    def _attach_anchors(self, per: int) -> None:
        import math

        a = 1 << max(10, min(15, int(math.ceil(
            math.log2(max(per, 2) / 12.0)))))
        a = min(a, max(self.shard_cap, 1))
        key = (a,)
        if self._reseed_fn is None or self._reseed_key != key:
            self._reseed_fn = make_anchor_reseed(self.mesh, a)
            self._reseed_key = key
        self._key, sub = jax.random.split(self._key)
        self.state = self._reseed_fn(self.state, sub)
        self._anchor_n = per

    def _make_step(self):
        """shard_map'd batched build step (shared by build and insert)."""
        if "step" in self._step_fns:
            return self._step_fns["step"]
        cfg, levels_cap, mesh = self.cfg, self.levels_cap, self.mesh
        specs = jax.tree.map(
            lambda _: P(SHARD_AXIS), init_state(0, cfg, levels_cap)
        )

        @functools.partial(jax.jit, donate_argnums=(0,))
        def step(state, xb, lb, eb, vb):
            def local(st, xb, lb, eb, vb):
                st = _strip(st)
                st = build_batch_impl(st, xb[0], lb[0], eb[0], vb[0], cfg, levels_cap)
                return _stack1(st)

            return shard_map(
                local,
                mesh=mesh,
                in_specs=(specs, P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS)),
                out_specs=specs,
            )(state, xb, lb, eb, vb)

        self._step_fns["step"] = step
        return step

    # ------------------------------------------------------ incremental insert
    def insert(self, x) -> None:
        """Buffered incremental insert; points are routed round-robin across
        shards and appended with the same shard_map'd batch step as build
        (flushed on the next search). Global external ids stay dense."""
        x = np.array(x, np.float32, copy=True)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[-1] != self.cfg.dim:
            raise ValueError(
                f"dimension mismatch: index dim {self.cfg.dim}, got {x.shape[-1]}"
            )
        self._pending.append(x)

    add = insert

    def flush(self) -> None:
        self._flush()

    def _flush(self) -> None:
        if not self._pending:
            return
        new = np.concatenate(self._pending, axis=0)
        self._pending = []
        if self.state is None:
            self.build(new)
            return
        s = self.n_shards
        base = self._n
        per = -(-new.shape[0] // s)
        bsz = min(self.cfg.build_batch, max(per, 1))
        nb = -(-per // bsz)
        # capacity: per-shard live counts + appended batch blocks
        n_per = np.asarray(jax.device_get(self.state.n))   # [S]
        need = int(n_per.max()) + nb * bsz
        if need > self.shard_cap:
            self._grow(max(need, 2 * self.shard_cap))
        self._key, sub = jax.random.split(self._key)
        levels = sample_levels(sub, new.shape[0], self.cfg.m, self.levels_cap,
                               self.cfg.ml)
        shard_sharding = NamedSharding(self.mesh, P(SHARD_AXIS))
        step = self._make_step()
        state = self.state
        for t in range(nb):
            xb = np.zeros((s, bsz, self.cfg.dim), np.float32)
            lb = np.full((s, bsz), -1, np.int32)
            eb = np.full((s, bsz), -1, np.int32)
            vb = np.zeros((s, bsz), bool)
            for si in range(s):
                lo = si * per + t * bsz
                hi = min(lo + bsz, min((si + 1) * per, new.shape[0]))
                cnt = max(hi - lo, 0)
                if cnt == 0:
                    continue
                xb[si, :cnt] = new[lo:hi]
                lb[si, :cnt] = levels[lo:hi]
                eb[si, :cnt] = base + np.arange(lo, hi, dtype=np.int32)
                vb[si, :cnt] = True
            state = step(
                state,
                jax.device_put(xb, shard_sharding),
                jax.device_put(lb, shard_sharding),
                jax.device_put(eb, shard_sharding),
                jax.device_put(vb, shard_sharding),
            )
        self.state = state
        self._n = base + new.shape[0]
        # anchor refresh on growth (see CagraIndex._reseed_anchors rationale)
        n_after = int(np.asarray(jax.device_get(state.n)).max())
        if self.state.anchors.shape[1] > 0 \
                and n_after >= 2 * max(self._anchor_n, 1):
            self._attach_anchors(n_after)
            self._search_fn = None

    def _grow(self, new_cap: int) -> None:
        """Grow every shard's capacity (stacked leaves; trash row re-created
        at the new cap index)."""
        bsz = min(self.cfg.build_batch, max(new_cap, 1))
        new_cap = -(-new_cap // bsz) * bsz
        s = self.n_shards
        old = self.state
        cap = self.shard_cap
        cfg, levels_cap = self.cfg, self.levels_cap
        shard_sharding = NamedSharding(self.mesh, P(SHARD_AXIS))

        def grow(old):
            grown = jax.tree.map(
                lambda a: jnp.broadcast_to(a[None], (s,) + a.shape),
                init_state(new_cap, cfg, levels_cap),
            )
            return HNSWState(
                vectors=grown.vectors.at[:, :cap].set(old.vectors),
                norms=grown.norms.at[:, :cap].set(old.norms),
                nbr0=grown.nbr0.at[:, :cap].set(old.nbr0[:, :-1]),
                nbrU=grown.nbrU.at[:, :, :cap].set(old.nbrU[:, :, :-1]),
                dist0=grown.dist0.at[:, :cap].set(old.dist0[:, :-1]),
                distU=grown.distU.at[:, :, :cap].set(old.distU[:, :, :-1]),
                levels=grown.levels.at[:, :cap].set(old.levels),
                ext_ids=grown.ext_ids.at[:, :cap].set(old.ext_ids),
                entry=old.entry,
                max_level=old.max_level,
                n=old.n,
                q_scale=old.q_scale,
                anchors=old.anchors,
                a_norms=old.a_norms,
                a_rows=old.a_rows,
            )

        specs = jax.tree.map(lambda _: NamedSharding(self.mesh, P(SHARD_AXIS)),
                             old)
        # no donation: the old (smaller) buffers can never alias the grown
        # outputs (shape mismatch -> "donated buffers were not usable")
        self.state = jax.jit(grow, out_shardings=specs)(old)
        self.shard_cap = new_cap
        self._search_fn = None

    # ------------------------------------------------------------ persistence
    def save(self, path: str) -> None:
        import dataclasses
        import json

        self._flush()
        meta = dict(cfg=dataclasses.asdict(self.cfg),
                    search_cfg=dataclasses.asdict(self.search_cfg),
                    levels_cap=self.levels_cap, shard_cap=self.shard_cap,
                    n=self._n, n_shards=self.n_shards)
        arrays = {}
        if self.state is not None:
            for f in HNSWState._fields:
                v = np.asarray(getattr(self.state, f))
                if str(v.dtype) == "bfloat16":
                    v = v.astype(np.float32)
                arrays[f] = v
            if self._dead:
                arrays["dead_ext"] = np.asarray(sorted(self._dead), np.int64)
        np.savez_compressed(path, meta=json.dumps(meta), **arrays)

    @classmethod
    def load(cls, path: str, mesh: Optional[Mesh] = None) -> "ShardedHNSW":
        import json

        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            cfg = HNSWConfig(**meta["cfg"])
            scfg = SearchConfig(**meta["search_cfg"])
            idx = cls(cfg, scfg, mesh=mesh)
            if idx.n_shards != meta["n_shards"]:
                raise ValueError(
                    f"saved with {meta['n_shards']} shards, mesh has {idx.n_shards}"
                )
            idx.levels_cap = meta["levels_cap"]
            idx.shard_cap = meta["shard_cap"]
            idx._n = meta["n"]
            if "vectors" in z:
                sh = NamedSharding(idx.mesh, P(SHARD_AXIS))
                idx.state = HNSWState(**{
                    f: jax.device_put(
                        jnp.asarray(z[f], cfg.storage_dtype if f == "vectors"
                                    else None), sh
                    )
                    for f in HNSWState._fields
                })
                idx._anchor_n = int(np.asarray(z["n"]).max())
                if "dead_ext" in z:
                    dead = np.asarray(z["dead_ext"], np.int64)
                    idx._dead = set(int(i) for i in dead)
                    ext = np.asarray(z["ext_ids"])
                    rr, cc = np.nonzero(np.isin(ext, dead))
                    idx._sync_dead_mask()
                    idx._dead_mask = idx._dead_mask.at[
                        jnp.asarray(rr), jnp.asarray(cc)].set(True)
        return idx

    # ----------------------------------------------------------------- search
    def _make_search(self, k: int, ef: int, with_dead: bool = False):
        cfg, scfg, levels_cap = self.cfg, self.search_cfg, self.levels_cap
        mesh = self.mesh
        specs = _state_specs(self.state)
        qspec = P(DATA_AXIS) if self.n_data > 1 else P()

        @jax.jit
        def run(state, dead_mask, q):
            def local(st, dead, q):
                st = _strip(st)
                s, ext, _ = search_state_impl(
                    st, q, k, cfg.metric, ef,
                    expand=scfg.expand, max_iters=scfg.max_iters,
                    max_upper_iters=scfg.max_upper_iters, levels_cap=levels_cap,
                    precision=cfg.precision,
                    dead=dead[0] if with_dead else None,
                )
                return s[:, None, :], ext[:, None, :]   # [Bl, 1, k]

            s, ext = shard_map(
                local, mesh=mesh,
                in_specs=(specs, P(SHARD_AXIS), qspec),
                out_specs=(P(DATA_AXIS if self.n_data > 1 else None, SHARD_AXIS),
                           P(DATA_AXIS if self.n_data > 1 else None, SHARD_AXIS)),
            )(state, dead_mask, q)
            b = s.shape[0]
            s = s.reshape(b, -1)       # [B, S*k] — XLA all-gathers these
            ext = ext.reshape(b, -1)
            # merge: smaller surrogate first; user scores for l2 ascend, for
            # dot/cosine descend — negate similarity to reuse ascending top-k
            key = s if cfg.metric == "l2" else -s
            mk, mi = T.smallest_k(key, ext, k)
            merged_s = mk if cfg.metric == "l2" else -mk
            return merged_s, mi

        return run

    def search(self, q, k: int, ef_search: Optional[int] = None,
               allowed=None, filter_mode: str = "auto"):
        """allowed: optional allowlist over global ids. filter_mode "auto"
        (default) = "scan" unless the global corpus is past the measured
        crossover AND the filter is near-all-pass (utils/filter_policy.py);
        "scan" answers filtered queries with the EXACT per-shard masked
        scan + global merge (parallel/scan_filter.py — the round-4 measured
        policy: the beam path collapses at selective filters); "beam" keeps
        the tombstone-mask beam path (raise ef_search)."""
        if filter_mode not in ("auto", "scan", "beam"):
            raise ValueError(f"invalid filter_mode {filter_mode!r}")
        self._flush()
        if filter_mode == "auto":
            from ..utils.filter_policy import resolve_filter_mode

            filter_mode = resolve_filter_mode(
                "auto", allowed, self._n, alt="beam")
        if self.state is None or self._n == 0:
            q = np.atleast_2d(np.asarray(q, np.float32))
            s = np.full((q.shape[0], k), np.inf if self.cfg.metric == "l2" else -np.inf)
            return jnp.asarray(s), jnp.full((q.shape[0], k), -1, jnp.int32)
        if allowed is not None and filter_mode == "scan":
            from ..utils.masks import allowed_mask
            from .scan_filter import make_sharded_masked_scan

            st = self.state
            av = allowed_mask(allowed, self._n, self._n)
            ext = st.ext_ids                              # [S, cap] by row
            ok = jnp.take(av, jnp.maximum(ext, 0)) & (ext >= 0)
            if bool(self._dead):
                self._sync_dead_mask()
                ok = ok & ~self._dead_mask[:, : ext.shape[1]]
            bias = jnp.where(ok, 0.0, jnp.inf)
            key = ("scanfilt", k)
            if getattr(self, "_scanfilt_key", None) != key:
                self._scanfilt_fn = make_sharded_masked_scan(
                    self.mesh, self.n_data, self.cfg.metric,
                    self.cfg.precision, k)
                self._scanfilt_key = key
            scales = jnp.broadcast_to(
                jnp.reshape(st.q_scale, (-1, 1)), ext.shape)
            q = jnp.atleast_2d(jnp.asarray(q, jnp.float32))
            return self._scanfilt_fn(st.vectors, st.norms + bias, scales,
                                     ext, q)
        ef = ef_search if ef_search is not None else self.search_cfg.ef_search
        # search_cfg participates in the cache key: _make_search captures it
        # in the jitted closure, so a reassigned idx.search_cfg must rebuild
        # (frozen dataclass -> hashable)
        with_dead = bool(self._dead) or allowed is not None
        if bool(self._dead):
            self._sync_dead_mask()
            dead = self._dead_mask
        elif allowed is not None:
            dead = jnp.zeros((self.n_shards, self.state.nbr0.shape[1]), bool)
        else:   # cached placeholder; ignored by the local fn
            if self._dead_placeholder is None:
                self._dead_placeholder = jax.device_put(
                    jnp.zeros((self.n_shards, 1), bool),
                    NamedSharding(self.mesh, P(SHARD_AXIS)))
            dead = self._dead_placeholder
        if allowed is not None:
            from ..utils.masks import allowed_mask

            av = allowed_mask(allowed, self._n, self._n)
            ext = self.state.ext_ids                      # [S, cap] by row
            block = ~(jnp.take(av, jnp.maximum(ext, 0)) & (ext >= 0))
            block = jnp.pad(block,
                            ((0, 0), (0, dead.shape[1] - block.shape[1])),
                            constant_values=True)          # trash row
            dead = dead | block
        key = (k, ef, self.search_cfg, with_dead)
        if self._search_fn is None or self._search_key != key:
            self._search_fn = self._make_search(k, ef, with_dead)
            self._search_key = key
        q = jnp.atleast_2d(jnp.asarray(q, jnp.float32))
        return self._search_fn(self.state, dead, q)
