"""Mesh-sharded brute-force search (the flat engine scaled out over a mesh).

The 100M-vector configuration (BASELINE.json config 5) in its simplest form:
vectors sharded over the mesh `shard` axis, every device scores its slice
with dense matmuls + approx top-k, and the per-shard top-k merge rides an
all-gather that XLA inserts from the sharding annotations. There is zero
cross-shard traffic until the final [B, S*k] merge.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..index.flat import FlatState
from ..ops import distance as D
from ..ops import topk as T
from ..utils.config import FlatConfig, config_from_dict
from .mesh import SHARD_AXIS, make_mesh
from .mesh import shard_map


class ShardedFlat:
    """Brute-force index sharded over a device mesh."""

    def __init__(self, cfg: FlatConfig, mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_shards = self.mesh.shape[SHARD_AXIS]
        self.state = None      # stacked FlatState: leading shard axis
        self._n = 0
        self._fns = {}
        self._pending: list[np.ndarray] = []
        self._per_shard_n: Optional[np.ndarray] = None
        self._dead: set[int] = set()   # tombstoned global ids

    def __len__(self) -> int:
        return (self._n + sum(p.shape[0] for p in self._pending)
                - len(self._dead))

    def remove(self, ids) -> int:
        """Delete by global id (tombstone; same mark-and-filter contract as
        the single-chip engines — see tests/test_delete.py). One scatter per
        shard setting the rows' norm validity bias to +inf; ids never
        renumber. Returns the number of rows newly deleted."""
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
        grid = np.asarray(self.state["ids"])
        rr, cc = np.nonzero(np.isin(grid, new))
        self.state = dict(
            self.state,
            norms=self.state["norms"].at[jnp.asarray(rr), jnp.asarray(cc)]
            .set(jnp.inf),
        )
        self._dead.update(int(i) for i in new)
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
        ids = np.asarray(self.state["ids"])
        vecs = np.asarray(self.state["vectors"], np.float32)
        x_all = np.empty((self._n, self.cfg.dim), np.float32)
        sel = ids >= 0
        x_all[ids[sel]] = vecs[sel]
        self.build(x_all[live])
        return live

    def build(self, x) -> None:
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        s = self.n_shards
        per = -(-max(n, 1) // s)
        self._n = n
        xs = np.zeros((s, per, self.cfg.dim), np.float32)
        ids = np.full((s, per), -1, np.int32)
        for si in range(s):
            lo, hi = si * per, min((si + 1) * per, n)
            if hi > lo:
                xs[si, : hi - lo] = x[lo:hi]
                ids[si, : hi - lo] = np.arange(lo, hi, dtype=np.int32)
        stored, norms = D.preprocess_corpus(
            jnp.asarray(xs), self.cfg.metric, self.cfg.storage_dtype
        )
        norms = jnp.where(ids >= 0, norms, jnp.inf)
        sh = NamedSharding(self.mesh, P(SHARD_AXIS))
        self.state = dict(
            vectors=jax.device_put(stored, sh),
            norms=jax.device_put(norms, sh),
            ids=jax.device_put(jnp.asarray(ids), sh),
        )
        self._per_shard_n = (ids >= 0).sum(1)
        self._pending = []
        self._fns = {}
        self._dead = set()

    # ------------------------------------------------------ incremental insert
    def add(self, x) -> None:
        """Buffered append; flushed on the next search. New rows are routed to
        the least-loaded shards; global ids stay dense insertion-order."""
        x = np.array(x, np.float32, copy=True)
        if x.ndim == 1:
            x = x[None, :]
        self._pending.append(x)

    insert = add

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
        # least-loaded routing (keeps scan work balanced)
        order = np.argsort(self._per_shard_n, kind="stable")
        per = -(-new.shape[0] // s)
        shard_of = np.empty(new.shape[0], np.int64)
        for j, si in enumerate(order):
            shard_of[j * per: (j + 1) * per] = si
        need = int((np.bincount(shard_of, minlength=s) + self._per_shard_n).max())
        cap = self.state["vectors"].shape[1]
        if need > cap:
            self._grow(max(need, 2 * cap))
            cap = self.state["vectors"].shape[1]   # pad writes target this OOB row
        chunk = per
        xb = np.zeros((s, chunk, self.cfg.dim), np.float32)
        idb = np.full((s, chunk), -1, np.int32)
        fill = np.zeros(s, np.int64)
        for i in range(new.shape[0]):
            si = shard_of[i]
            xb[si, fill[si]] = new[i]
            idb[si, fill[si]] = self._n + i
            fill[si] += 1
        stored, norms = D.preprocess_corpus(
            jnp.asarray(xb), self.cfg.metric, self.cfg.storage_dtype
        )
        norms = jnp.where(jnp.asarray(idb) >= 0, norms, jnp.inf)
        st = self.state
        counts = jnp.asarray(self._per_shard_n, jnp.int32)
        rows = jnp.repeat(jnp.arange(s), chunk)
        cols = (counts[:, None] + jnp.arange(chunk)[None, :])
        cols = jnp.where(jnp.asarray(idb) >= 0, cols, cap).reshape(-1)  # drop pads
        self.state = dict(
            vectors=st["vectors"].at[rows, cols].set(
                stored.reshape(-1, self.cfg.dim), mode="drop"),
            norms=st["norms"].at[rows, cols].set(norms.reshape(-1), mode="drop"),
            ids=st["ids"].at[rows, cols].set(
                jnp.asarray(idb).reshape(-1), mode="drop"),
        )
        self._per_shard_n = self._per_shard_n + np.bincount(shard_of, minlength=s)
        self._n += new.shape[0]

    def _grow(self, new_cap: int) -> None:
        s = self.n_shards
        st = self.state
        cap = st["vectors"].shape[1]
        sh = NamedSharding(self.mesh, P(SHARD_AXIS))

        def grow(st):
            return dict(
                vectors=jnp.zeros((s, new_cap, self.cfg.dim),
                                  st["vectors"].dtype).at[:, :cap].set(st["vectors"]),
                norms=jnp.full((s, new_cap), jnp.inf,
                               jnp.float32).at[:, :cap].set(st["norms"]),
                ids=jnp.full((s, new_cap), -1,
                             jnp.int32).at[:, :cap].set(st["ids"]),
            )

        specs = {k2: sh for k2 in st}
        self.state = jax.jit(grow, out_shardings=specs)(st)
        self._fns = {}

    # ------------------------------------------------------------ persistence
    def save(self, path: str) -> None:
        import dataclasses
        import json

        self._flush()
        meta = dict(cfg=dataclasses.asdict(self.cfg), n=self._n,
                    n_shards=self.n_shards)
        arrays = {}
        if self.state is not None:
            for k2, v in self.state.items():
                v = np.asarray(v)
                if str(v.dtype) == "bfloat16":
                    v = v.astype(np.float32)
                arrays[k2] = v
        np.savez_compressed(path, meta=json.dumps(meta), **arrays)

    @classmethod
    def load(cls, path: str, mesh: Optional[Mesh] = None) -> "ShardedFlat":
        import json

        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            cfg = config_from_dict(FlatConfig, meta["cfg"])
            idx = cls(cfg, mesh=mesh)
            if idx.n_shards != meta["n_shards"]:
                raise ValueError(
                    f"saved with {meta['n_shards']} shards, mesh has {idx.n_shards}"
                )
            idx._n = meta["n"]
            if "vectors" in z:
                sh = NamedSharding(idx.mesh, P(SHARD_AXIS))
                ids = np.asarray(z["ids"])
                idx.state = dict(
                    vectors=jax.device_put(
                        jnp.asarray(z["vectors"], cfg.storage_dtype), sh),
                    norms=jax.device_put(jnp.asarray(z["norms"]), sh),
                    ids=jax.device_put(jnp.asarray(ids), sh),
                )
                idx._per_shard_n = (ids >= 0).sum(1)
                # tombstones ride in norms: live slot (id >= 0) + inf norm
                dead = ids[(ids >= 0) & np.isinf(np.asarray(z["norms"]))]
                idx._dead = set(int(i) for i in dead)
        return idx

    def _make(self, k: int, approx: bool):
        cfg = self.cfg
        mesh = self.mesh
        prec = D.matmul_precision(cfg.precision)

        @jax.jit
        def run(vectors, norms, ids, q):
            def local(v, nn, ii, q):
                v, nn, ii = v[0], nn[0], ii[0]
                qp = D.preprocess_queries(q, cfg.metric)
                s = D.pairwise_scores(qp, v, nn, cfg.metric, precision=prec)
                s = jnp.where(ii[None, :] >= 0, s, jnp.inf)
                kk = min(k, s.shape[-1])
                if approx:
                    tv, tp = jax.lax.approx_min_k(
                        s, kk, recall_target=cfg.recall_target
                    )
                    ti = jnp.take_along_axis(
                        jnp.broadcast_to(ii[None, :], s.shape), tp, axis=-1
                    )
                    ts = jnp.where(ti >= 0, tv, jnp.inf)
                else:
                    ts, ti = T.smallest_k(s, jnp.broadcast_to(ii[None, :], s.shape), kk)
                # tombstoned rows carry a live-looking id but an inf score;
                # never let them surface when < k finite candidates exist
                ti = jnp.where(jnp.isfinite(ts), ti, -1)
                return ts[:, None, :], ti[:, None, :]

            ts, ti = shard_map(
                local, mesh=mesh,
                in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS), P()),
                out_specs=(P(None, SHARD_AXIS), P(None, SHARD_AXIS)),
            )(vectors, norms, ids, q)
            b = ts.shape[0]
            ts = ts.reshape(b, -1)
            ti = ti.reshape(b, -1)
            ms, mi = T.smallest_k(ts, ti, k)
            user = D.finalize_scores(ms, D.preprocess_queries(q, cfg.metric), cfg.metric)
            user = jnp.where(mi >= 0, user, jnp.inf if cfg.metric == "l2" else -jnp.inf)
            return user, mi

        return run

    def _make_range(self, max_results: int):
        cfg = self.cfg
        mesh = self.mesh
        prec = D.matmul_precision(cfg.precision)
        is_l2 = cfg.metric == "l2"

        @jax.jit
        def run(vectors, norms, ids, q, radius):
            def local(v, nn, ii, q, radius):
                v, nn, ii = v[0], nn[0], ii[0]
                qp = D.preprocess_queries(q, cfg.metric)
                s = D.pairwise_scores(qp, v, nn, cfg.metric, precision=prec)
                s = jnp.where(ii[None, :] >= 0, s, jnp.inf)
                user = D.finalize_scores(s, qp, cfg.metric)   # user-facing
                valid = jnp.isfinite(s)
                in_r = valid & ((user <= radius) if is_l2 else (user >= radius))
                cnt = jnp.sum(in_r, axis=-1).astype(jnp.int32)   # [B]
                kk = min(max_results, s.shape[-1])
                ts, ti = T.smallest_k(
                    s, jnp.broadcast_to(ii[None, :], s.shape), kk)
                ti = jnp.where(jnp.isfinite(ts), ti, -1)
                if kk < max_results:
                    pad = max_results - kk
                    ts = jnp.pad(ts, ((0, 0), (0, pad)),
                                 constant_values=jnp.inf)
                    ti = jnp.pad(ti, ((0, 0), (0, pad)), constant_values=-1)
                return ts[:, None, :], ti[:, None, :], cnt[:, None]

            ts, ti, cnt = shard_map(
                local, mesh=mesh,
                in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS), P(),
                          P()),
                out_specs=(P(None, SHARD_AXIS), P(None, SHARD_AXIS),
                           P(None, SHARD_AXIS)),
            )(vectors, norms, ids, q, radius)
            b = ts.shape[0]
            counts = jnp.sum(cnt, axis=-1)                   # [B]
            ms, mi = T.smallest_k(ts.reshape(b, -1), ti.reshape(b, -1),
                                  max_results)
            user = D.finalize_scores(
                ms, D.preprocess_queries(q, cfg.metric), cfg.metric)
            in_r = (mi >= 0) & ((user <= radius) if is_l2
                                else (user >= radius))
            mi = jnp.where(in_r, mi, -1)
            user = jnp.where(in_r, user, jnp.inf if is_l2 else -jnp.inf)
            return user, mi, counts

        return run

    def search_range(self, q, radius: float, max_results: int = 128):
        """All neighbors within `radius` across every shard (same contract
        as FlatIndex.search_range: squared-L2 <= radius for l2, similarity
        >= radius otherwise). Returns (scores [B, R], ids [B, R], counts
        [B]); counts is the EXACT global in-range total (per-shard counts
        summed over the mesh), rows hold the R globally-best when truncated.
        Each shard contributes its top-R so the global top-R is always a
        subset of the gathered pool. radius is traced (one compiled program
        serves every radius)."""
        self._flush()
        q = jnp.atleast_2d(jnp.asarray(q, jnp.float32))
        if q.shape[-1] != self.cfg.dim:
            raise ValueError(
                f"dimension mismatch: index dim {self.cfg.dim}, "
                f"got {q.shape[-1]}")
        if self.state is None or self._n == 0:
            return (
                jnp.full((q.shape[0], max_results),
                         jnp.inf if self.cfg.metric == "l2" else -jnp.inf),
                jnp.full((q.shape[0], max_results), -1, jnp.int32),
                jnp.zeros((q.shape[0],), jnp.int32),
            )
        key = ("range", max_results)
        if key not in self._fns:
            self._fns[key] = self._make_range(max_results)
        st = self.state
        return self._fns[key](st["vectors"], st["norms"], st["ids"], q,
                              jnp.asarray(radius, jnp.float32))

    def search(self, q, k: int, approx: bool = True, allowed=None):
        """allowed: optional allowlist over global ids (bool mask or id
        array) — filtered search, exact at any selectivity (one per-call
        validity-bias mask over the full scan)."""
        self._flush()
        if self.state is None or self._n == 0:
            q = np.atleast_2d(np.asarray(q, np.float32))
            return (
                jnp.full((q.shape[0], k), jnp.inf if self.cfg.metric == "l2" else -jnp.inf),
                jnp.full((q.shape[0], k), -1, jnp.int32),
            )
        key = (k, approx)
        if key not in self._fns:
            self._fns[key] = self._make(k, approx)
        q = jnp.atleast_2d(jnp.asarray(q, jnp.float32))
        st = self.state
        norms = st["norms"]
        if allowed is not None:
            from ..utils.masks import allowed_mask

            av = allowed_mask(allowed, self._n, self._n)   # [n] bool, device
            ok = jnp.take(av, jnp.maximum(st["ids"], 0)) & (st["ids"] >= 0)
            norms = jnp.where(ok, norms, jnp.inf)
        return self._fns[key](st["vectors"], norms, st["ids"], q)
