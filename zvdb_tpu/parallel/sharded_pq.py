"""Mesh-sharded product-quantized search — the 100M-per-pod configuration.

PQ is the memory-scaling engine (codes are n_sub bytes/vector, ops/pq.py);
sharding it over the mesh `shard` axis is what makes BASELINE config 5
(100M vectors) comfortable: at n_sub=16 + int8 refine, 100M rows are
~12 GB in total, spread over the mesh's devices.

Design mirrors ShardedFlat (sharded_flat.py): codes/norms/refine/ids are
sharded on `shard`, codebooks are replicated (they are KB-scale), every
device scans its slice with the gather-free decode-tile scan
(index/pqflat.py:_pq_scan), reranks its own candidates against its LOCAL refine store
(zero cross-shard gathers — the refine row fetch stays on-chip), and the
per-shard exact top-k merge rides the all-gather XLA inserts from the
sharding annotations.

Semantics note: with refine enabled, each shard refines its own
k*rerank-candidate pool and surfaces k exact-scored rows; the global
merge picks the best k of the S*k survivors. The candidate pool is
therefore S× WIDER than the single-chip engine at equal `rerank` —
sharded recall at a given config is >= the single-chip number (same
relationship as ShardedIVF's per-shard probe widening, sharded_ivf.py).

No reference counterpart: the reference is single-address-space
(src/hnsw.zig:6,50); this extends its capability axes across devices
(SURVEY.md §2.3).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..index.pqflat import PQState, _pq_scan
from ..ops import distance as D
from ..ops import pq as PQ
from ..ops import topk as T
from ..utils.config import PQConfig, config_from_dict
from .mesh import SHARD_AXIS, make_mesh
from .mesh import shard_map


class ShardedPQFlat:
    """Product-quantized index sharded over a device mesh."""

    def __init__(self, cfg: PQConfig, mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_shards = self.mesh.shape[SHARD_AXIS]
        self.state = None          # dict of [S, per, ...] arrays, shard-sharded
        self.codebooks = None      # [n_sub, C, dsub] f32, replicated
        # OPQ rotation, replicated ([0, 0] sentinel when cfg.opq is off);
        # codes live in x@rot space, the refine store stays original-space
        # (same split as PQFlatIndex)
        self.rot = jnp.zeros((0, 0), jnp.float32)
        self._trained = False
        self._n = 0
        self._fns = {}
        self._pending: list[np.ndarray] = []
        self._per_shard_n: Optional[np.ndarray] = None
        self._dead: set[int] = set()

    def __len__(self) -> int:
        return (self._n + sum(p.shape[0] for p in self._pending)
                - len(self._dead))

    @property
    def _refine_d(self) -> int:
        return self.cfg.dim if self.cfg.refine != "none" else 0

    # ------------------------------------------------------------ construction

    def _train(self, x: np.ndarray) -> None:
        """Codebooks from a sample of x (host numpy, pre-metric). Trained once
        and frozen — same contract as PQFlatIndex (index/pqflat.py:196)."""
        cfg = self.cfg
        n = x.shape[0]
        if n > cfg.train_sample:
            sel = np.random.default_rng(cfg.seed).choice(
                n, cfg.train_sample, replace=False)
            xs = x[np.sort(sel)]
        else:
            xs = x
        xf = D.preprocess_queries(jnp.asarray(xs, jnp.float32), cfg.metric)
        key = jax.random.PRNGKey(cfg.seed)
        if cfg.opq:
            self.rot, self.codebooks = PQ.train_opq(
                xf, key, cfg.n_sub, cfg.n_codes, cfg.kmeans_iters,
                cfg.opq_iters)
        else:
            self.codebooks = PQ.train_codebooks(
                xf, key, cfg.n_sub, cfg.n_codes, cfg.kmeans_iters)
        self._trained = True

    def _encode_block(self, xs: np.ndarray, ids: np.ndarray):
        """[S, per, D] host layout -> device (codes, norms, refine, r_scales)
        in the same [S, per, ...] layout; pad slots (id -1) get norm +inf."""
        cfg = self.cfg
        s, per, d = xs.shape
        xf = D.preprocess_queries(jnp.asarray(xs.reshape(-1, d)), cfg.metric)
        codes = PQ.encode(PQ.apply_rotation(xf, self.rot), self.codebooks)
        if cfg.metric == "l2":
            norms = PQ.decoded_sq_norms(codes, self.codebooks)
        else:
            norms = jnp.zeros((s * per,), jnp.float32)
        norms = jnp.where(jnp.asarray(ids.reshape(-1)) >= 0, norms, jnp.inf)
        if cfg.refine in ("int8", "int16"):
            rrows, rscales, _ = D.quantize_corpus(
                xf, cfg.metric, bits=8 if cfg.refine == "int8" else 16)
        elif cfg.refine == "none":
            rrows = jnp.zeros((s * per, 0), jnp.float32)
            rscales = jnp.ones((s * per,), jnp.float32)
        else:
            rrows = xf.astype(cfg.refine_dtype)
            rscales = jnp.ones((s * per,), jnp.float32)
        return (codes.reshape(s, per, cfg.n_sub),
                norms.reshape(s, per),
                rrows.reshape(s, per, -1),
                rscales.reshape(s, per))

    def build(self, x) -> None:
        x = np.asarray(x, np.float32)
        if x.shape[-1] != self.cfg.dim:
            raise ValueError(
                f"dimension mismatch: index dim {self.cfg.dim}, "
                f"got {x.shape[-1]}")
        n = x.shape[0]
        s = self.n_shards
        per = -(-max(n, 1) // s)
        self._n = n
        self._train(x)
        xs = np.zeros((s, per, self.cfg.dim), np.float32)
        ids = np.full((s, per), -1, np.int32)
        for si in range(s):
            lo, hi = si * per, min((si + 1) * per, n)
            if hi > lo:
                xs[si, : hi - lo] = x[lo:hi]
                ids[si, : hi - lo] = np.arange(lo, hi, dtype=np.int32)
        codes, norms, refine, r_scales = self._encode_block(xs, ids)
        sh = NamedSharding(self.mesh, P(SHARD_AXIS))
        self.state = dict(
            codes=jax.device_put(codes, sh),
            norms=jax.device_put(norms, sh),
            refine=jax.device_put(refine, sh),
            r_scales=jax.device_put(r_scales, sh),
            ids=jax.device_put(jnp.asarray(ids), sh),
        )
        self._per_shard_n = (ids >= 0).sum(1)
        self._pending = []
        self._fns = {}
        self._dead = set()

    # ------------------------------------------------------ incremental insert

    def add(self, x) -> None:
        """Buffered append; flushed on the next search. New rows encode
        against the FROZEN codebooks (PQConfig contract) and route to the
        least-loaded shards; global ids stay dense insertion-order."""
        x = np.array(x, np.float32, copy=True)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[-1] != self.cfg.dim:
            raise ValueError(
                f"dimension mismatch: index dim {self.cfg.dim}, "
                f"got {x.shape[-1]}")
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
        order = np.argsort(self._per_shard_n, kind="stable")
        per = -(-new.shape[0] // s)
        shard_of = np.empty(new.shape[0], np.int64)
        for j, si in enumerate(order):
            shard_of[j * per: (j + 1) * per] = si
        shard_of = shard_of[: new.shape[0]]
        need = int((np.bincount(shard_of, minlength=s)
                    + self._per_shard_n).max())
        cap = self.state["codes"].shape[1]
        if need > cap:
            self._grow(max(need, 2 * cap))
            cap = self.state["codes"].shape[1]
        xb = np.zeros((s, per, self.cfg.dim), np.float32)
        idb = np.full((s, per), -1, np.int32)
        fill = np.zeros(s, np.int64)
        for i in range(new.shape[0]):
            si = shard_of[i]
            xb[si, fill[si]] = new[i]
            idb[si, fill[si]] = self._n + i
            fill[si] += 1
        codes, norms, refine, r_scales = self._encode_block(xb, idb)
        st = self.state
        counts = jnp.asarray(self._per_shard_n, jnp.int32)
        rows = jnp.repeat(jnp.arange(s), per)
        cols = counts[:, None] + jnp.arange(per)[None, :]
        # pads target column `cap` and drop out of bounds
        cols = jnp.where(jnp.asarray(idb) >= 0, cols, cap).reshape(-1)
        self.state = dict(
            codes=st["codes"].at[rows, cols].set(
                codes.reshape(-1, self.cfg.n_sub), mode="drop"),
            norms=st["norms"].at[rows, cols].set(
                norms.reshape(-1), mode="drop"),
            refine=st["refine"].at[rows, cols].set(
                refine.reshape(-1, self._refine_d), mode="drop"),
            r_scales=st["r_scales"].at[rows, cols].set(
                r_scales.reshape(-1), mode="drop"),
            ids=st["ids"].at[rows, cols].set(
                jnp.asarray(idb).reshape(-1), mode="drop"),
        )
        self._per_shard_n = (self._per_shard_n
                             + np.bincount(shard_of, minlength=s))
        self._n += new.shape[0]

    def _grow(self, new_cap: int) -> None:
        s = self.n_shards
        st = self.state
        cap = st["codes"].shape[1]
        sh = NamedSharding(self.mesh, P(SHARD_AXIS))
        rd = self._refine_d

        def grow(st):
            return dict(
                codes=jnp.zeros((s, new_cap, self.cfg.n_sub),
                                jnp.uint8).at[:, :cap].set(st["codes"]),
                norms=jnp.full((s, new_cap), jnp.inf,
                               jnp.float32).at[:, :cap].set(st["norms"]),
                refine=jnp.zeros((s, new_cap, rd),
                                 st["refine"].dtype).at[:, :cap].set(
                                     st["refine"]),
                r_scales=jnp.ones((s, new_cap),
                                  jnp.float32).at[:, :cap].set(st["r_scales"]),
                ids=jnp.full((s, new_cap), -1,
                             jnp.int32).at[:, :cap].set(st["ids"]),
            )

        specs = {k2: sh for k2 in st}
        self.state = jax.jit(grow, out_shardings=specs)(st)
        self._fns = {}

    # ------------------------------------------------------------ mutation

    def remove(self, ids) -> int:
        """Tombstone by global id (mark-and-filter; ids never renumber —
        same contract as the whole family, tests/test_delete.py). One
        scatter flips the rows' norm validity bias to +inf; the PQ scan and
        the refine pass both inherit the exclusion."""
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
        order. Codes/refine rows move VERBATIM (no re-encode — same contract
        as PQFlatIndex.compact) and re-balance across shards. Returns the
        survivors' old ids."""
        self._flush()
        alive = np.ones(self._n, bool)
        if self._dead:
            alive[np.fromiter(self._dead, np.int64, len(self._dead))] = False
        live = np.flatnonzero(alive)
        if self.state is None or not self._dead:
            self._dead = set()
            return live
        st = {k2: np.asarray(v) for k2, v in self.state.items()}
        ids = st["ids"]
        sel = (ids >= 0) & alive[np.maximum(ids, 0)]
        rr, cc = np.nonzero(sel)
        order = np.argsort(ids[rr, cc], kind="stable")
        rr, cc = rr[order], cc[order]
        n = rr.size
        s = self.n_shards
        per = -(-max(n, 1) // s)
        out = {
            "codes": np.zeros((s, per, self.cfg.n_sub), np.uint8),
            "norms": np.full((s, per), np.inf, np.float32),
            "refine": np.zeros((s, per, self._refine_d),
                               st["refine"].dtype),
            "r_scales": np.ones((s, per), np.float32),
            "ids": np.full((s, per), -1, np.int32),
        }
        for si in range(s):
            lo, hi = si * per, min((si + 1) * per, n)
            if hi > lo:
                out["codes"][si, : hi - lo] = st["codes"][rr[lo:hi], cc[lo:hi]]
                out["norms"][si, : hi - lo] = st["norms"][rr[lo:hi], cc[lo:hi]]
                out["refine"][si, : hi - lo] = st["refine"][rr[lo:hi],
                                                            cc[lo:hi]]
                out["r_scales"][si, : hi - lo] = st["r_scales"][rr[lo:hi],
                                                                cc[lo:hi]]
                out["ids"][si, : hi - lo] = np.arange(lo, hi, dtype=np.int32)
        sh = NamedSharding(self.mesh, P(SHARD_AXIS))
        self.state = {k2: jax.device_put(jnp.asarray(v), sh)
                      for k2, v in out.items()}
        self._per_shard_n = (out["ids"] >= 0).sum(1)
        self._n = n
        self._fns = {}
        self._dead = set()
        return live

    # ------------------------------------------------------------ persistence

    def save(self, path: str) -> None:
        import dataclasses
        import json

        self._flush()
        meta = dict(cfg=dataclasses.asdict(self.cfg), n=self._n,
                    n_shards=self.n_shards, trained=self._trained)
        arrays = {"rot": np.asarray(self.rot)}
        if self.codebooks is not None:
            arrays["codebooks"] = np.asarray(self.codebooks)
        if self.state is not None:
            for k2, v in self.state.items():
                v = np.asarray(v)
                if str(v.dtype) == "bfloat16":
                    v = v.astype(np.float32)
                arrays[k2] = v
        np.savez_compressed(path, meta=json.dumps(meta), **arrays)

    @classmethod
    def load(cls, path: str, mesh: Optional[Mesh] = None) -> "ShardedPQFlat":
        import json

        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            cfg = config_from_dict(PQConfig, meta["cfg"])
            idx = cls(cfg, mesh=mesh)
            if idx.n_shards != meta["n_shards"]:
                raise ValueError(
                    f"saved with {meta['n_shards']} shards, "
                    f"mesh has {idx.n_shards}")
            idx._n = meta["n"]
            idx._trained = bool(meta["trained"])
            if "codebooks" in z:
                idx.codebooks = jnp.asarray(z["codebooks"])
            if "rot" in z:   # absent in pre-OPQ snapshots -> sentinel stays
                idx.rot = jnp.asarray(z["rot"])
            if "codes" in z:
                sh = NamedSharding(idx.mesh, P(SHARD_AXIS))
                ids = np.asarray(z["ids"])
                idx.state = dict(
                    codes=jax.device_put(jnp.asarray(z["codes"]), sh),
                    norms=jax.device_put(jnp.asarray(z["norms"]), sh),
                    refine=jax.device_put(
                        jnp.asarray(z["refine"], cfg.refine_dtype), sh),
                    r_scales=jax.device_put(jnp.asarray(z["r_scales"]), sh),
                    ids=jax.device_put(jnp.asarray(ids), sh),
                )
                idx._per_shard_n = (ids >= 0).sum(1)
                dead = ids[(ids >= 0) & np.isinf(np.asarray(z["norms"]))]
                idx._dead = set(int(i) for i in dead)
        return idx

    # ------------------------------------------------------------ reads

    def get(self, ids) -> np.ndarray:
        """Stored representation for global ids -> [K, D] f32 (refine store
        when present, PQ reconstruction otherwise — PQFlatIndex.get)."""
        self._flush()
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        if ids.size == 0:
            return np.zeros((0, self.cfg.dim), np.float32)
        if (ids < 0).any() or (ids >= self._n).any():
            raise IndexError(f"ids must be in [0, {self._n})")
        if self._dead and any(int(i) in self._dead for i in ids):
            raise IndexError("id was deleted")
        grid = np.asarray(self.state["ids"])
        flat = grid.reshape(-1)
        order = np.argsort(flat, kind="stable")
        locs = order[np.searchsorted(flat, ids, sorter=order)]
        rr, cc = np.unravel_index(locs, grid.shape)
        if self.cfg.refine != "none":
            vecs = np.asarray(self.state["refine"])[rr, cc].astype(np.float32)
            if self.cfg.refine in ("int8", "int16"):
                vecs = vecs * np.asarray(self.state["r_scales"])[rr, cc][:, None]
            return vecs
        codes = jnp.asarray(np.asarray(self.state["codes"])[rr, cc])
        dec = PQ.decode(codes, self.codebooks)
        # OPQ codes reconstruct x@rot; rotate back (rot orthogonal)
        return np.asarray(PQ.apply_rotation(dec, self.rot.T))

    # ------------------------------------------------------------ search

    def _make(self, k: int, approx: bool, rerank: int):
        cfg = self.cfg
        mesh = self.mesh

        @jax.jit
        def run(codes, norms, refine, r_scales, ids, codebooks, rot, q):
            qs = D.preprocess_queries(q, cfg.metric)
            # scan in (possibly OPQ-rotated) code space; refine rerank keeps
            # the original qs against the original-space refine store
            qr = PQ.apply_rotation(qs, rot)

            def local(c, nn, rv, rs, ii, cb, qr, qs):
                c, nn, rv, rs, ii = c[0], nn[0], rv[0], rs[0], ii[0]
                cap = c.shape[0]
                pool = max(k * rerank, k) if cfg.refine != "none" else k
                st = PQState(codes=c, norms=nn, codebooks=cb,
                             rot=jnp.zeros((0, 0), jnp.float32),
                             refine=rv, r_scales=rs,
                             n=jnp.asarray(cap, jnp.int32))
                ps, pi = _pq_scan(st, qr, pool, cfg.metric, cfg.tile_n,
                                  approx, cfg.recall_target, cfg.precision)
                if cfg.refine != "none":
                    safe = jnp.maximum(pi, 0)
                    cand = jnp.take(rv, safe, axis=0).astype(jnp.float32)
                    if cfg.refine in ("int8", "int16"):
                        cand = cand * jnp.take(rs, safe)[..., None]
                    dots = jnp.einsum("bd,bcd->bc", qs, cand,
                                      preferred_element_type=jnp.float32,
                                      precision=jax.lax.Precision.HIGHEST)
                    if cfg.metric == "l2":
                        ex = jnp.sum(cand * cand, axis=-1) - 2.0 * dots
                    else:
                        ex = -dots
                    ps = jnp.where(pi >= 0, ex, jnp.inf)
                gi = jnp.where(pi >= 0, jnp.take(ii, jnp.maximum(pi, 0)), -1)
                ts, ti = T.smallest_k(ps, gi, k)
                ti = jnp.where(jnp.isfinite(ts), ti, -1)
                return ts[:, None, :], ti[:, None, :]

            ts, ti = shard_map(
                local, mesh=mesh,
                in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
                          P(SHARD_AXIS), P(SHARD_AXIS), P(), P(), P()),
                out_specs=(P(None, SHARD_AXIS), P(None, SHARD_AXIS)),
            )(codes, norms, refine, r_scales, ids, codebooks, qr, qs)
            b = ts.shape[0]
            ms, mi = T.smallest_k(ts.reshape(b, -1), ti.reshape(b, -1), k)
            user = D.finalize_scores(ms, qs, cfg.metric)
            user = jnp.where(mi >= 0, user,
                             jnp.inf if cfg.metric == "l2" else -jnp.inf)
            return user, mi

        return run

    def search(self, q, k: int, approx: bool = True, allowed=None,
               rerank: int | None = None):
        """Top-k over the mesh. allowed: optional allowlist over global ids
        (bool mask or id array) — one per-call validity-bias mask, exact at
        any selectivity; the per-shard refine pool is post-filter.
        rerank: per-call override of cfg.rerank (per-SHARD refine-pool depth
        = k * rerank), same convention as PQFlatIndex.search."""
        self._flush()
        q = jnp.atleast_2d(jnp.asarray(q, jnp.float32))
        if q.shape[-1] != self.cfg.dim:
            raise ValueError(
                f"dimension mismatch: index dim {self.cfg.dim}, "
                f"got {q.shape[-1]}")
        if self.state is None or self._n == 0 or not self._trained:
            return (
                jnp.full((q.shape[0], k),
                         jnp.inf if self.cfg.metric == "l2" else -jnp.inf),
                jnp.full((q.shape[0], k), -1, jnp.int32),
            )
        rr = self.cfg.rerank if rerank is None else int(rerank)
        key = (k, approx, rr)
        if key not in self._fns:
            self._fns[key] = self._make(k, approx, rr)
        st = self.state
        norms = st["norms"]
        if allowed is not None:
            from ..utils.masks import allowed_mask

            av = allowed_mask(allowed, self._n, self._n)
            ok = jnp.take(av, jnp.maximum(st["ids"], 0)) & (st["ids"] >= 0)
            norms = jnp.where(ok, norms, jnp.inf)
        return self._fns[key](st["codes"], norms, st["refine"],
                              st["r_scales"], st["ids"], self.codebooks,
                              self.rot, q)
