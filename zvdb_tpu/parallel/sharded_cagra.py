"""Mesh-sharded CAGRA: the flagship graph engine over a device mesh.

Same parallelism shape as ShardedHNSW (SURVEY.md §2.3 — the expert-parallel
analog: corpus partitioned over the shard axis, per-shard single-layer
graphs, query fan-out, all-gather top-k merge; contrast reference
src/hnsw.zig:74's global mutex):

  * search: cagra_search_impl per shard under shard_map — graph gathers never
    cross shards; the [B, S*k] merge rides a sharding-derived all-gather.
  * incremental insert: round-robin routed, appended with the SAME jitted
    extend step as the single-chip engine (cagra._extend_batch_impl) run
    SPMD under shard_map — O(new) per insert, every shard extends its own
    subgraph simultaneously.
  * bulk build: each shard's graph comes from the all-matmul cluster-kNN builder
    (knn_graph.build_knn_graph). The builder is host-orchestrated (block
    packing bookkeeping runs on the host), so shard graphs are constructed
    one at a time and device_put into the stacked sharded layout — build is
    per-shard sequential, search/insert are SPMD. External ids are tracked in
    a stacked [S, cap] table so results carry global insertion-order ids.
"""
from __future__ import annotations

import dataclasses
import functools
import json
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..index.cagra import (
    CagraConfig, CagraState, _extend_batch_impl, _pick_anchor_rows,
    cagra_search_impl, _SearchArrays,
)
from ..index.knn_graph import build_knn_graph_multi
from ..ops import distance as D
from ..ops import topk as T
from .mesh import DATA_AXIS, SHARD_AXIS, make_mesh
from .mesh import shard_map

INF = jnp.inf


class ShardedCagra:
    """Mesh-sharded CagraIndex. API mirrors the single-chip class."""

    def __init__(self, cfg: CagraConfig, mesh: Optional[Mesh] = None,
                 seed: int = 0):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_shards = self.mesh.shape[SHARD_AXIS]
        self.n_data = self.mesh.shape.get(DATA_AXIS, 1)
        self.state: Optional[CagraState] = None   # stacked [S, ...] leaves
        self.ext_ids: Optional[jax.Array] = None  # [S, cap] int32, -1 pad
        self.shard_cap = 0
        self._key = jax.random.PRNGKey(seed)
        self._n = 0
        self._pending: list[np.ndarray] = []
        self._search_fn = None
        self._search_key = None
        self._step_fn = None
        self._reseed_fn = None
        self._anchor_n = 0   # max per-shard n at the last anchor snapshot
        self._dead: set[int] = set()              # tombstoned global ids
        self._dead_mask: Optional[jax.Array] = None  # [S, cap] bool

    def __len__(self) -> int:
        return (self._n + sum(p.shape[0] for p in self._pending)
                - len(self._dead))

    def remove(self, ids) -> int:
        """Delete by global id (mark-and-filter, same contract as the
        single-chip engines): tombstoned nodes keep routing per-shard beams
        and are filtered from each shard's beam before the global merge.
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
        ext = np.asarray(self.ext_ids)
        rr, cc = np.nonzero(np.isin(ext, new))
        self._sync_dead_mask()
        self._dead_mask = self._dead_mask.at[
            jnp.asarray(rr), jnp.asarray(cc)].set(True)
        self._dead.update(int(i) for i in new)
        self._search_fn = None   # signature gains the mask input
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
        ext = np.asarray(self.ext_ids)                       # [S, cap]
        vecs = np.asarray(self.state.vectors, np.float32)    # [S, cap, D]
        if self.cfg.dtype == "int8":
            vecs = vecs * np.asarray(self.state.q_scale)[:, None, None]
        x_all = np.empty((self._n, self.cfg.dim), np.float32)
        sel = ext >= 0
        x_all[ext[sel]] = vecs[sel]
        self.build(x_all[live])
        return live

    def _sync_dead_mask(self) -> None:
        """Create/grow the stacked [S, cap] tombstone mask to the current
        shard capacity (extends regrow the state arrays)."""
        cap = self.ext_ids.shape[1]
        sh = self._sharding()
        if self._dead_mask is None:
            self._dead_mask = jax.device_put(
                jnp.zeros((self.n_shards, cap), bool), sh)
        elif self._dead_mask.shape[1] < cap:
            grown = jnp.zeros((self.n_shards, cap), bool)
            grown = grown.at[:, : self._dead_mask.shape[1]].set(
                self._dead_mask)
            self._dead_mask = jax.device_put(grown, sh)

    @property
    def dim(self) -> int:
        return self.cfg.dim

    def _sharding(self):
        return NamedSharding(self.mesh, P(SHARD_AXIS))

    # ------------------------------------------------------------------ build
    def build(self, x) -> None:
        """Contiguous split across shards; per-shard all-matmul graph builds run
        PHASE-INTERLEAVED (knn_graph.build_knn_graph_multi): every shard's
        k-means/assignment/block-kNN work is dispatched — on its own mesh
        device on a real multi-chip backend — before the host blocks on any
        shard's assignment pull, so device phases overlap across shards and
        the host packing of shard i overlaps the device work of the rest.
        On the single-core CI host the virtual devices share one core, so the
        interleaving is throughput-neutral there (docs/PERF.md)."""
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        cfg = self.cfg
        s = self.n_shards
        per = -(-n // s) if n else 1
        bsz = min(cfg.build_batch, max(per, 1))
        cap = -(-per // bsz) * bsz
        self.shard_cap = cap
        self._n = n
        self._pending = []
        self._search_fn = None
        self._dead = set()
        self._dead_mask = None
        if cfg.metric == "cosine" and n:
            x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)

        lohi = [(si * per, min((si + 1) * per, n)) for si in range(s)]
        live = [si for si in range(s) if lohi[si][1] - lohi[si][0] > 0]
        keys = {si: jax.random.split(jax.random.PRNGKey(cfg.seed + si), 2)
                for si in live}
        # per-shard device placement parallelizes builds on a real mesh;
        # skipped on CPU, where it would only multiply per-device compiles
        place = jax.default_backend() != "cpu"
        dev_of = {si: (self.mesh.devices[0, si] if place else None)
                  for si in range(s)}
        g_out = build_knn_graph_multi(
            [x[lohi[si][0]:lohi[si][1]] for si in live],
            cfg.degree, [keys[si][0] for si in live],
            devices=[dev_of[si] for si in live],
            precision=cfg.precision, metric=cfg.metric, block=cfg.block,
            spill=cfg.spill, passes=cfg.passes,
            kmeans_iters=cfg.kmeans_iters, alpha=cfg.alpha,
            reps=cfg.seed_reps, n_long=cfg.n_long,
            kc_per_view=cfg.kc_per_view, prune_cap=cfg.prune_cap,
            block_topk=cfg.block_topk, kmeans_sample=cfg.kmeans_sample,
        )

        shard_states = []
        ext = np.full((s, cap), -1, np.int32)
        a_count = None
        gi = 0
        for si in range(s):
            lo, hi = lohi[si]
            cnt = max(hi - lo, 0)
            if cnt == 0:
                # tail shards of a small corpus (n < s*per) receive no points
                # — allocate the empty grown state directly; anchors pad to
                # a_count below
                st = _empty_cagra_state(cfg, cap)
            else:
                nbrs, dists, *_ = g_out[gi]
                gi += 1
                st = _shard_state(cfg, x[lo:hi], nbrs, dists, cap,
                                  keys[si][1], dev_of[si])
                ext[si, :cnt] = np.arange(lo, hi, dtype=np.int32)
            if a_count is None:
                a_count = st.anchors.shape[0]
            elif st.anchors.shape[0] != a_count:
                # pad/trim anchor tables to a uniform stacked shape
                st = _pad_anchors(st, a_count)
            shard_states.append(st)

        sh = self._sharding()
        self.state = jax.tree.map(
            lambda *leaves: jax.device_put(jnp.stack(leaves), sh), *shard_states
        )
        self.ext_ids = jax.device_put(jnp.asarray(ext), sh)
        self._anchor_n = per

    # ------------------------------------------------------ incremental insert
    def insert(self, x) -> None:
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

    def _make_step(self):
        if self._step_fn is not None:
            return self._step_fn
        cfg, mesh = self.cfg, self.mesh

        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def step(state, ext_ids, xb, vb, eb):
            specs = jax.tree.map(lambda _: P(SHARD_AXIS), state)

            def local(st, ext, xb, vb, eb):
                st1 = jax.tree.map(lambda a: a[0], st)
                base = st1.n
                st1 = _extend_batch_impl(st1, xb[0], vb[0], cfg)
                rows = base + jnp.arange(xb.shape[1], dtype=jnp.int32)
                ext = ext.at[0, rows].set(
                    jnp.where(vb[0], eb[0], jnp.take(ext[0], rows)),
                    mode="drop",
                )
                return jax.tree.map(lambda a: a[None], st1), ext

            return shard_map(
                local, mesh=mesh,
                in_specs=(specs, P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
                          P(SHARD_AXIS)),
                out_specs=(specs, P(SHARD_AXIS)),
            )(state, ext_ids, xb, vb, eb)

        self._step_fn = step
        return step

    def _flush(self) -> None:
        if not self._pending:
            return
        new = np.concatenate(self._pending, axis=0)
        self._pending = []
        if self.state is None or self._n == 0:
            # rebuild-from-scratch also covers an all-empty built state, whose
            # shards have no anchor tables to seed the SPMD extend step with
            base = self._n
            self.build(new)
            self._n = base + new.shape[0]
            return
        s = self.n_shards
        base = self._n
        per = -(-new.shape[0] // s)
        bsz = min(self.cfg.build_batch, max(per, 1))
        nb = -(-per // bsz)
        n_per = np.asarray(jax.device_get(self.state.n))
        need = int(n_per.max()) + nb * bsz
        if need > self.shard_cap:
            self._grow(max(need, 2 * self.shard_cap))
        sh = self._sharding()
        step = self._make_step()
        state, ext_ids = self.state, self.ext_ids
        for t in range(nb):
            xb = np.zeros((s, bsz, self.cfg.dim), np.float32)
            vb = np.zeros((s, bsz), bool)
            eb = np.full((s, bsz), -1, np.int32)
            for si in range(s):
                lo = si * per + t * bsz
                hi = min(lo + bsz, min((si + 1) * per, new.shape[0]))
                cnt = max(hi - lo, 0)
                if cnt == 0:
                    continue
                xb[si, :cnt] = new[lo:hi]
                vb[si, :cnt] = True
                eb[si, :cnt] = base + np.arange(lo, hi, dtype=np.int32)
            state, ext_ids = step(
                state, ext_ids,
                jax.device_put(xb, sh), jax.device_put(vb, sh),
                jax.device_put(eb, sh),
            )
        self.state, self.ext_ids = state, ext_ids
        self._n = base + new.shape[0]
        # Anchor refresh on growth (shape-stable: same anchor count, rows
        # resampled over each shard's current [0, n) — grown shards would
        # otherwise seed beams only from their build-time region).
        n_after = int(np.asarray(jax.device_get(state.n)).max())
        if state.anchors.shape[1] > 0 and n_after >= 2 * max(self._anchor_n, 1):
            if self._reseed_fn is None:
                self._reseed_fn = self._make_reseed()
            self._key, sub = jax.random.split(self._key)
            self.state = self._reseed_fn(self.state, sub)
            self._anchor_n = n_after
        self._search_fn = None

    def _make_reseed(self):
        mesh = self.mesh

        @jax.jit
        def reseed(state, key):
            specs = jax.tree.map(lambda _: P(SHARD_AXIS), state)

            def local(st, key):
                st1 = jax.tree.map(lambda a: a[0], st)
                k = jax.random.fold_in(key, jax.lax.axis_index(SHARD_AXIS))
                a = st1.a_rows.shape[0]
                # with-replacement sample keeps the shape static; slight
                # anchor duplication costs ~0 seed quality at a >= 1024
                rows = jax.random.randint(
                    k, (a,), 0, jnp.maximum(st1.n, 1), jnp.int32)
                anchors = jnp.take(st1.vectors, rows, axis=0) \
                    .astype(jnp.float32) * st1.q_scale
                st1 = st1._replace(anchors=anchors,
                                   a_norms=jnp.take(st1.norms, rows),
                                   a_rows=rows)
                return jax.tree.map(lambda x: x[None], st1)

            return shard_map(local, mesh=mesh, in_specs=(specs, P()),
                             out_specs=specs)(state, key)

        return reseed

    def _grow(self, new_cap: int) -> None:
        bsz = min(self.cfg.build_batch, max(new_cap, 1))
        new_cap = -(-new_cap // bsz) * bsz
        cap = self.shard_cap
        deg = self.cfg.degree
        d = self.cfg.dim
        s = self.n_shards
        old, old_ext = self.state, self.ext_ids
        sdt = self.cfg.storage_dtype

        def grow(old, old_ext):
            return CagraState(
                vectors=jnp.zeros((s, new_cap, d), sdt)
                .at[:, :cap].set(old.vectors),
                norms=jnp.zeros((s, new_cap), jnp.float32)
                .at[:, :cap].set(old.norms),
                nbrs=jnp.full((s, new_cap + 1, deg), -1, jnp.int32)
                .at[:, :cap].set(old.nbrs[:, :-1]),
                dists=jnp.full((s, new_cap + 1, deg), jnp.inf, jnp.float32)
                .at[:, :cap].set(old.dists[:, :-1]),
                anchors=old.anchors, a_norms=old.a_norms, a_rows=old.a_rows,
                n=old.n, q_scale=old.q_scale,
            ), jnp.full((s, new_cap), -1, jnp.int32).at[:, :cap].set(old_ext)

        sh = self._sharding()
        out_shardings = (jax.tree.map(lambda _: sh, old), sh)
        # no donation: old (smaller) buffers can never alias the grown outputs
        # — donating them only produced "donated buffers were not usable"
        # warnings; they are freed when `old` drops out of scope regardless
        self.state, self.ext_ids = jax.jit(
            grow, out_shardings=out_shardings)(old, old_ext)
        self.shard_cap = new_cap
        self._search_fn = None

    # ----------------------------------------------------------------- search
    def _make_search(self, k: int, ef: int, with_dead: bool):
        cfg, mesh = self.cfg, self.mesh
        specs = jax.tree.map(lambda _: P(SHARD_AXIS), self.state)
        qspec = P(DATA_AXIS) if self.n_data > 1 else P()

        @jax.jit
        def run(state, ext_ids, dead_mask, q):
            def local(st, ext, dead, q):
                st1 = jax.tree.map(lambda a: a[0], st)
                arrs = _SearchArrays(
                    table=st1.vectors, norms=st1.norms, nbrs=st1.nbrs,
                    anchors=st1.anchors, a_norms=st1.a_norms,
                    a_rows=st1.a_rows, n=st1.n, q_scale=st1.q_scale,
                    dead=dead[0] if with_dead else None,
                )
                s_, rows = cagra_search_impl(
                    arrs, q, k, cfg.metric, ef, cfg.n_seeds, cfg.expand,
                    cfg.max_iters, cfg.precision, packed=False, fat=False,
                    dedupe=True, seed_approx=cfg.seed_approx,
                    search_degree=cfg.search_degree,
                )
                g = jnp.where(rows >= 0,
                              jnp.take(ext[0], jnp.maximum(rows, 0)), -1)
                return s_[:, None, :], g[:, None, :]

            s_, g = shard_map(
                local, mesh=mesh,
                in_specs=(specs, P(SHARD_AXIS), P(SHARD_AXIS), qspec),
                out_specs=(P(DATA_AXIS if self.n_data > 1 else None, SHARD_AXIS),
                           P(DATA_AXIS if self.n_data > 1 else None, SHARD_AXIS)),
            )(state, ext_ids, dead_mask, q)
            b = s_.shape[0]
            s_ = s_.reshape(b, -1)
            g = g.reshape(b, -1)
            key = s_ if cfg.metric == "l2" else -s_
            key = jnp.where(g >= 0, key, INF)
            mk, mi = T.smallest_k(key, g, k)
            merged = mk if cfg.metric == "l2" else -mk
            merged = jnp.where(mi >= 0, merged,
                               INF if cfg.metric == "l2" else -INF)
            return merged, mi

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
        # jnp, not np: device-resident query batches must not round-trip
        # through the host
        q = jnp.atleast_2d(jnp.asarray(q, jnp.float32))
        if q.shape[-1] != self.cfg.dim:
            raise ValueError(
                f"dimension mismatch: index dim {self.cfg.dim}, got {q.shape[-1]}"
            )
        if self.state is None or self._n == 0:
            s = np.full((q.shape[0], k),
                        np.inf if self.cfg.metric == "l2" else -np.inf)
            return jnp.asarray(s), jnp.full((q.shape[0], k), -1, jnp.int32)
        if allowed is not None and filter_mode == "scan":
            from ..utils.masks import allowed_mask
            from .scan_filter import make_sharded_masked_scan

            av = allowed_mask(allowed, self._n, self._n)
            ok = (jnp.take(av, jnp.maximum(self.ext_ids, 0))
                  & (self.ext_ids >= 0))
            if bool(self._dead):
                self._sync_dead_mask()
                ok = ok & ~self._dead_mask
            st = self.state
            bias = jnp.where(ok, 0.0, jnp.inf)
            key = ("scanfilt", k)
            if getattr(self, "_scanfilt_key", None) != key:
                self._scanfilt_fn = make_sharded_masked_scan(
                    self.mesh, self.n_data, self.cfg.metric,
                    self.cfg.precision, k)
                self._scanfilt_key = key
            scales = jnp.broadcast_to(
                jnp.reshape(st.q_scale, (-1, 1)), self.ext_ids.shape)
            return self._scanfilt_fn(st.vectors, st.norms + bias, scales,
                                     self.ext_ids, q)
        ef = ef_search if ef_search is not None else self.cfg.ef_search
        with_dead = bool(self._dead) or allowed is not None
        if bool(self._dead):
            self._sync_dead_mask()
            dead = self._dead_mask
        elif allowed is not None:
            dead = jnp.zeros(self.ext_ids.shape, bool)
        else:   # cached placeholder rides the same signature; local ignores it
            if getattr(self, "_dead_placeholder", None) is None:
                self._dead_placeholder = jax.device_put(
                    jnp.zeros((self.n_shards, 1), bool), self._sharding())
            dead = self._dead_placeholder
        if allowed is not None:
            from ..utils.masks import allowed_mask

            av = allowed_mask(allowed, self._n, self._n)
            block = ~(jnp.take(av, jnp.maximum(self.ext_ids, 0))
                      & (self.ext_ids >= 0))
            dead = dead | block
        key = (k, ef, with_dead)
        if self._search_fn is None or self._search_key != key:
            self._search_fn = self._make_search(k, ef, with_dead)
            self._search_key = key
        return self._search_fn(self.state, self.ext_ids, dead, q)

    # ------------------------------------------------------------ persistence
    def save(self, path: str) -> None:
        self._flush()
        meta = dict(cfg=dataclasses.asdict(self.cfg), shard_cap=self.shard_cap,
                    n=self._n, n_shards=self.n_shards)
        arrays = {}
        if self.state is not None:
            for f in CagraState._fields:
                v = np.asarray(getattr(self.state, f))
                if str(v.dtype) == "bfloat16":
                    v = v.astype(np.float32)
                arrays[f] = v
            arrays["ext_ids"] = np.asarray(self.ext_ids)
            if self._dead:
                arrays["dead_ext"] = np.asarray(sorted(self._dead), np.int64)
        np.savez_compressed(path, meta=json.dumps(meta), **arrays)

    @classmethod
    def load(cls, path: str, mesh: Optional[Mesh] = None) -> "ShardedCagra":
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            cfg = CagraConfig(**meta["cfg"])
            idx = cls(cfg, mesh=mesh)
            if idx.n_shards != meta["n_shards"]:
                raise ValueError(
                    f"saved with {meta['n_shards']} shards, mesh has {idx.n_shards}"
                )
            idx.shard_cap = meta["shard_cap"]
            idx._n = meta["n"]
            if "vectors" in z:
                sh = idx._sharding()
                idx.state = CagraState(**{
                    f: jax.device_put(
                        jnp.asarray(z[f], cfg.storage_dtype if f == "vectors"
                                    else None), sh)
                    for f in CagraState._fields
                })
                idx.ext_ids = jax.device_put(jnp.asarray(z["ext_ids"]), sh)
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


def _shard_state(cfg: CagraConfig, xs: np.ndarray, nbrs, dists, cap: int,
                 akey, device=None) -> CagraState:
    """Assemble one shard's CagraState at capacity `cap` from its built graph
    (mirrors CagraIndex.build's ingest + anchor epilogue, without the
    intermediate n-capacity allocation + grow copy)."""
    cnt = xs.shape[0]
    xj = jnp.asarray(xs, jnp.float32)
    if device is not None:
        xj = jax.device_put(xj, device)
    q_scale = 1.0
    if cfg.dtype == "int8":
        q_scale = max(float(np.abs(xs).max()) if cnt else 1.0, 1e-12) / 127.0
        stored, norms = D.quantize_corpus_global(
            xj, cfg.metric, jnp.asarray(q_scale, jnp.float32))
    else:
        stored, norms = D.preprocess_corpus(xj, cfg.metric, cfg.storage_dtype)
    a_rows = _pick_anchor_rows(akey, cnt, cfg.n_anchors)
    anchors = jnp.take(stored, a_rows, axis=0).astype(jnp.float32) * q_scale
    a_norms = jnp.take(norms, a_rows) if cfg.metric == "l2" \
        else jnp.zeros((a_rows.shape[0],), jnp.float32)
    d, deg = cfg.dim, cfg.degree
    return CagraState(
        vectors=jnp.zeros((cap, d), cfg.storage_dtype).at[:cnt].set(stored),
        norms=jnp.zeros((cap,), jnp.float32).at[:cnt].set(norms),
        nbrs=jnp.full((cap + 1, deg), -1, jnp.int32).at[:cnt].set(nbrs[:cnt]),
        dists=jnp.full((cap + 1, deg), jnp.inf, jnp.float32)
        .at[:cnt].set(dists[:cnt]),
        anchors=anchors, a_norms=a_norms, a_rows=a_rows,
        n=jnp.asarray(cnt, jnp.int32),
        q_scale=jnp.asarray(q_scale, jnp.float32),
    )


def _empty_cagra_state(cfg: CagraConfig, cap: int) -> CagraState:
    """Zero-point shard state at capacity `cap` (what CagraIndex.build would
    produce for an empty slice, grown): all-invalid adjacency, no anchors."""
    d, deg = cfg.dim, cfg.degree
    return CagraState(
        vectors=jnp.zeros((cap, d), cfg.storage_dtype),
        norms=jnp.zeros((cap,), jnp.float32),
        nbrs=jnp.full((cap + 1, deg), -1, jnp.int32),
        dists=jnp.full((cap + 1, deg), jnp.inf, jnp.float32),
        anchors=jnp.zeros((0, d), jnp.float32),
        a_norms=jnp.zeros((0,), jnp.float32),
        a_rows=jnp.zeros((0,), jnp.int32),
        n=jnp.asarray(0, jnp.int32),
        q_scale=jnp.asarray(1.0, jnp.float32),
    )


def _pad_anchors(st: CagraState, a_count: int) -> CagraState:
    a = st.anchors.shape[0]
    if a >= a_count:
        return st._replace(anchors=st.anchors[:a_count],
                           a_norms=st.a_norms[:a_count],
                           a_rows=st.a_rows[:a_count])
    pad = a_count - a
    return st._replace(
        anchors=jnp.pad(st.anchors, ((0, pad), (0, 0))),
        a_norms=jnp.pad(st.a_norms, (0, pad), constant_values=jnp.inf),
        a_rows=jnp.pad(st.a_rows, (0, pad), constant_values=0),
    )
