"""Mesh-sharded IVF: clusters are the sharding unit (the expert-parallel
analog — SURVEY.md §2.3 "shard-routed search: each index shard ≈ an expert").

Layout: one global k-means; clusters are then distributed across the mesh
`shard` axis greedily by size (largest-first onto the least-loaded shard) so
per-device scan work is balanced. Each device holds a complete local IVFState
over its clusters; queries are replicated, every shard probes its own top
`nprobe_local` local clusters with the grouped-matmul scan, and the per-shard
top-k merge is one all-gather + top-k that XLA derives from the sharding
annotations.

Rerank support: each shard stores its own densely-indexed shadow vectors (the
points living in its clusters) plus a local->global id map; block ids are
LOCAL indices during the scan and map to global external ids only after the
rerank rescore (ivf_search_impl's id_map parameter).

Incremental insert: new points are routed to their nearest global centroid on
the host, bucketed per owning shard, and appended into spare block capacity by
the same O(new) device append the single-chip engine uses — run under
shard_map so every shard appends its own bucket simultaneously. Overflow falls
back to a full rebuild from reconstructed vectors (ids stay stable: global ids
are dense insertion order).

Scaling: per-device work is 1/S of the single-device scan at matched total
nprobe.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..index.ivf import (
    IVFConfig, IVFIndex, IVFState, _ivf_append, ivf_search_impl,
)
from ..ops import topk as T
from .mesh import SHARD_AXIS, make_mesh
from .mesh import shard_map


class ShardedIVF:
    """IVF index with clusters sharded over a device mesh."""

    def __init__(self, cfg: IVFConfig, mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_shards = self.mesh.shape[SHARD_AXIS]
        self.state = None          # stacked IVFState (leading shard axis)
        self.c_mask = None         # [S, C_loc] bool
        self.id_map = None         # [S, n_loc_cap] int32 local->global (rerank)
        self._n = 0
        self._fns = {}
        self._pending: list[np.ndarray] = []
        # host routing copies (small): global centroids + cluster->(shard, local)
        self._cent_host: Optional[np.ndarray] = None
        self._cluster_of: Optional[np.ndarray] = None  # [C_glob, 2] (shard, local)
        self._dead: set[int] = set()   # tombstoned global ids

    def __len__(self) -> int:
        return (self._n + sum(p.shape[0] for p in self._pending)
                - len(self._dead))

    # ------------------------------------------------------------------ delete
    def remove(self, ids) -> int:
        """Delete by global id (tombstone; same -2-id encoding in b_ids as
        the single-chip IVF — every scan masks b_ids >= 0, all metrics).
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
        self._dead.update(int(i) for i in new)
        self._mark_dead(new)
        return int(new.size)

    def _decoded_slot_globals(self, ids_np: np.ndarray):
        """(decoded slot values, global id per slot). b_ids hold LOCAL ids
        when an id_map exists, else global ids; tombstones are -2-v."""
        dec = np.where(ids_np <= -2, -2 - ids_np, ids_np)
        if self.id_map is not None:
            im = np.asarray(self.id_map)
            glob = np.full(dec.shape, -1, np.int64)
            for si in range(self.n_shards):
                m = dec[si] >= 0
                glob[si][m] = im[si][dec[si][m]]
        else:
            glob = dec.astype(np.int64)
        return dec, glob

    def _mark_dead(self, dead_ids: np.ndarray) -> None:
        if dead_ids.size == 0 or self.state is None:
            return
        ids_np = np.asarray(self.state.b_ids)       # [S, C_loc, cap]
        dec, glob = self._decoded_slot_globals(ids_np)
        hit = np.isin(glob, dead_ids) & (glob >= 0) & (ids_np >= 0)
        ss, cc, bb = np.nonzero(hit)
        if ss.size == 0:
            return
        self.state = self.state._replace(
            b_ids=self.state.b_ids.at[
                jnp.asarray(ss), jnp.asarray(cc), jnp.asarray(bb)].set(
                    jnp.asarray(-2 - dec[ss, cc, bb], jnp.int32)))

    # ------------------------------------------------------------------ build
    def build(self, x) -> None:
        x = np.asarray(x, np.float32)
        single = IVFIndex(self.cfg)
        single.build(x)
        if self.cfg.metric == "cosine":
            x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        st = single.state
        self._n = int(st.n)
        self._pending = []
        self._dead = set()
        s = self.n_shards
        counts = np.asarray(st.counts)
        c = counts.shape[0]

        # greedy size-balanced cluster placement
        order = np.argsort(-counts, kind="stable")
        load = np.zeros(s, np.int64)
        members = [[] for _ in range(s)]
        for ci in order:
            tgt = int(np.argmin(load))
            members[tgt].append(ci)
            load[tgt] += counts[ci]
        c_loc = max(len(m) for m in members)
        self._cent_host = np.asarray(st.centroids)
        self._cluster_of = np.zeros((c, 2), np.int32)
        for si, m in enumerate(members):
            for li, ci in enumerate(m):
                self._cluster_of[ci] = (si, li)

        def stack(field, pad_value):
            arr = np.asarray(getattr(st, field))
            out = np.full((s, c_loc) + arr.shape[1:], pad_value, arr.dtype)
            for si, m in enumerate(members):
                out[si, : len(m)] = arr[m]
            return out

        cent = stack("centroids", 0.0)
        c_norms = stack("c_norms", np.inf)       # +inf: l2 pad never probed
        blocks = stack("blocks", 0)
        b_norms = stack("b_norms", np.inf)
        b_scales = stack("b_scales", 1.0)
        b_ids = stack("b_ids", -1)               # global ids at this point
        cnt = stack("counts", 0)
        mask = np.zeros((s, c_loc), bool)
        for si, m in enumerate(members):
            mask[si, : len(m)] = True

        if self.cfg.rerank:
            # per-shard shadow rows: remap block ids to local indices and keep
            # a local->global map (+ capacity headroom for appends)
            n_loc = [(b_ids[si] >= 0).sum() for si in range(s)]
            rcap = max(1024, -(-max(n_loc) // 1024) * 1024 + 1024)
            shadows = np.zeros((s, rcap, self.cfg.dim), np.float32)
            shadow_norms = np.zeros((s, rcap), np.float32)
            idmap = np.full((s, rcap), -1, np.int32)
            for si in range(s):
                sel = b_ids[si] >= 0
                glob = b_ids[si][sel]
                idmap[si, : glob.size] = glob
                shadows[si, : glob.size] = x[glob]
                if self.cfg.metric == "l2":
                    shadow_norms[si, : glob.size] = (
                        x[glob].astype(np.float64) ** 2
                    ).sum(-1).astype(np.float32)
                loc = np.full(self._n, -1, np.int64)
                loc[glob] = np.arange(glob.size)
                b_ids[si][sel] = loc[glob]
            rr_dtype = np.float32 if self.cfg.rerank_dtype == "float32" else jnp.bfloat16
            rr = jnp.asarray(shadows, rr_dtype)
            rrn = jnp.asarray(shadow_norms)
            n_arr = np.asarray(n_loc, np.int32)   # per-shard LOCAL live count
        else:
            rr = jnp.zeros((s, 0, self.cfg.dim), jnp.bfloat16)
            rrn = jnp.zeros((s, 0), jnp.float32)
            idmap = None
            n_arr = np.asarray([(b_ids[si] >= 0).sum() for si in range(s)],
                               np.int32)

        sh = NamedSharding(self.mesh, P(SHARD_AXIS))
        self.state = IVFState(
            centroids=jax.device_put(jnp.asarray(cent), sh),
            c_norms=jax.device_put(jnp.asarray(c_norms), sh),
            blocks=jax.device_put(jnp.asarray(blocks, self.cfg.storage_dtype), sh),
            b_norms=jax.device_put(jnp.asarray(b_norms), sh),
            b_scales=jax.device_put(jnp.asarray(b_scales), sh),
            b_ids=jax.device_put(jnp.asarray(b_ids), sh),
            counts=jax.device_put(jnp.asarray(cnt), sh),
            n=jax.device_put(jnp.asarray(n_arr), sh),
            rerank_vecs=jax.device_put(rr, sh),
            rerank_norms=jax.device_put(rrn, sh),
        )
        self.c_mask = jax.device_put(jnp.asarray(mask), sh)
        self.id_map = jax.device_put(jnp.asarray(idmap), sh) \
            if idmap is not None else None
        self._fns = {}

    # ----------------------------------------------------------------- search
    def _make(self, k: int, nprobe_local: int, with_allow: bool = False):
        cfg = self.cfg
        mesh = self.mesh
        specs = jax.tree.map(lambda _: P(SHARD_AXIS), self.state)
        use_map = self.id_map is not None

        @jax.jit
        def run(state, c_mask, id_map, allow, q):
            def local(st, cm, im, al, q):
                st = jax.tree.map(lambda a: a[0], st)
                s_, i_ = ivf_search_impl(
                    st, q, k, nprobe_local, cfg.metric, cfg.precision,
                    c_mask=cm[0], residual=cfg.dtype == "int8",
                    rerank=cfg.rerank,
                    id_map=im[0] if use_map else None,
                    allowed=al[0] if with_allow else None,
                    filter_widen=8 if with_allow else 1,
                )
                return s_[:, None, :], i_[:, None, :]

            s_, i_ = shard_map(
                local, mesh=mesh,
                in_specs=(specs, P(SHARD_AXIS), P(SHARD_AXIS),
                          P(SHARD_AXIS), P()),
                out_specs=(P(None, SHARD_AXIS), P(None, SHARD_AXIS)),
            )(state, c_mask, id_map, allow, q)
            b = s_.shape[0]
            s_ = s_.reshape(b, -1)
            i_ = i_.reshape(b, -1)
            key = s_ if cfg.metric == "l2" else -s_
            ms, mi = T.smallest_k(key, i_, k)
            return (ms if cfg.metric == "l2" else -ms), mi

        return run

    def search(self, q, k: int, nprobe: Optional[int] = None, allowed=None,
               filter_mode: str = "scan"):
        """Shard-routed search. `nprobe` is a GLOBAL budget: each shard
        probes its `ceil(nprobe/S) + 1` best LOCAL clusters, so the union
        probes between nprobe+S and the single-chip nprobe's cluster set.
        This is NOT identical to single-chip nprobe=p — the global p best
        clusters may concentrate on one shard, in which case that shard
        covers only ceil(p/S)+1 of them and recall can differ either way
        (usually UP: the aggregate probe count S*(ceil(p/S)+1) >= p+S, and
        the per-shard spread probes clusters the single-chip scan would
        skip). Tested floors: tests/test_sharded_ivf.py pins recall at
        matched global budgets; exact single-chip equivalence would need
        centroid-score all-gather routing (one [B, C_global] matmul +
        cross-shard probe exchange) — rejected: it serializes every search
        on a global top-p and ships probe lists between devices for no measured
        recall win at the tested scales.

        allowed: optional allowlist over global ids. filter_mode "auto"
        (default) = "scan" unless the global corpus is past the measured
        crossover AND the filter is near-all-pass (utils/filter_policy.py).
        "scan" (float dtypes) answers filtered queries with the EXACT
        per-shard masked scan of the grouped blocks + global merge
        (parallel/scan_filter.py — round-4 measured policy: probe-pool
        filtering lost to 0.256 recall at 1% selectivity even at 8x
        widening). "probe" (and int8 residual storage, which has no exact
        row form) filters the per-shard probe pools, widened 8x; forces
        the local-id+id_map layout on first use (one-time conversion)."""
        if filter_mode not in ("auto", "scan", "probe"):
            raise ValueError(f"invalid filter_mode {filter_mode!r}")
        self._flush()
        if filter_mode == "auto":
            from ..utils.filter_policy import resolve_filter_mode

            filter_mode = resolve_filter_mode(
                "auto", allowed, self._n, alt="probe")
        if self.state is None or self._n == 0:
            q = np.atleast_2d(np.asarray(q, np.float32))
            return (
                jnp.full((q.shape[0], k),
                         jnp.inf if self.cfg.metric == "l2" else -jnp.inf),
                jnp.full((q.shape[0], k), -1, jnp.int32),
            )
        if allowed is not None and filter_mode == "scan" \
                and self.cfg.dtype != "int8":
            from ..utils.masks import allowed_mask
            from .scan_filter import make_sharded_masked_scan

            st = self.state
            s_, d_ = st.blocks.shape[0], st.blocks.shape[-1]
            cb = st.blocks.reshape(s_, -1, d_)
            bi = st.b_ids.reshape(s_, -1)
            if self.id_map is not None:   # local-id layout -> global ids
                gi = jnp.take_along_axis(
                    self.id_map, jnp.maximum(bi, 0), axis=1)
                gi = jnp.where(bi >= 0, gi, -1)
            else:
                gi = jnp.where(bi >= 0, bi, -1)
            av = allowed_mask(allowed, self._n, self._n)
            ok = (gi >= 0) & jnp.take(av, jnp.maximum(gi, 0))
            bias = jnp.where(ok, 0.0, jnp.inf)
            gi = jnp.where(ok, gi, -1)
            key = ("scanfilt", k)
            if getattr(self, "_scanfilt_key", None) != key:
                self._scanfilt_fn = make_sharded_masked_scan(
                    self.mesh, getattr(self, "n_data", 1), self.cfg.metric,
                    self.cfg.precision, k)
                self._scanfilt_key = key
            q = jnp.atleast_2d(jnp.asarray(q, jnp.float32))
            return self._scanfilt_fn(
                cb, st.b_norms.reshape(s_, -1) + bias,
                st.b_scales.reshape(s_, -1), gi, q)
        p_total = nprobe or self.cfg.nprobe
        # each shard probes its local best; +1 covers placement imbalance
        p_local = min(
            max(1, -(-p_total // self.n_shards) + 1),
            self.state.centroids.shape[1],
        )
        with_allow = allowed is not None
        if with_allow and self.id_map is None:
            self._ensure_id_map(headroom=1024)
            self._fns = {}   # id_map layout changes the compiled search
        key = (k, p_local, with_allow, self.id_map is not None)
        if key not in self._fns:
            self._fns[key] = self._make(k, p_local, with_allow)
        q = jnp.atleast_2d(jnp.asarray(q, jnp.float32))
        id_map = self.id_map if self.id_map is not None else \
            jnp.zeros((self.n_shards, 0), jnp.int32)
        if with_allow:
            from ..utils.masks import allowed_mask

            av = allowed_mask(allowed, self._n, self._n)
            allow = jnp.take(av, jnp.maximum(id_map, 0)) & (id_map >= 0)
        else:
            allow = jnp.zeros((self.n_shards, 1), bool)
        return self._fns[key](self.state, self.c_mask, id_map, allow, q)

    # ------------------------------------------------------ incremental insert
    def add(self, x) -> None:
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
        cfg = self.cfg
        if cfg.metric == "cosine":
            new = new / np.maximum(np.linalg.norm(new, axis=1, keepdims=True), 1e-12)
        # host routing: nearest global centroid -> owning (shard, local cluster)
        cent = self._cent_host
        d = ((new[:, None, :] - cent[None]) ** 2).sum(-1) if new.shape[0] * len(cent) < 4_000_000 \
            else None
        if d is None:
            # chunked for large batches
            a = np.empty(new.shape[0], np.int64)
            for lo in range(0, new.shape[0], 4096):
                dd = ((new[lo:lo + 4096, None, :] - cent[None]) ** 2).sum(-1)
                a[lo:lo + 4096] = dd.argmin(1)
        else:
            a = d.argmin(1)
        shard_of = self._cluster_of[a, 0]
        local_cl = self._cluster_of[a, 1]
        s = self.n_shards
        c_loc = self.state.centroids.shape[1]
        bcap = self.state.blocks.shape[2]

        # overflow check against per-shard-cluster capacity
        counts = np.asarray(self.state.counts)           # [S, C_loc]
        addc = np.zeros_like(counts)
        np.add.at(addc, (shard_of, local_cl), 1)
        per_shard = np.bincount(shard_of, minlength=s)
        chunk = 1 << max(9, int(math.ceil(math.log2(max(per_shard.max(), 1)))))
        if (counts + addc).max() > bcap:   # a cluster block would overflow
            self._rebuild_with(new)
            return

        # bucket per shard, pad to `chunk`
        xb = np.zeros((s, chunk, cfg.dim), np.float32)
        ab = np.zeros((s, chunk), np.int32)
        vb = np.zeros((s, chunk), bool)
        gids = np.zeros((s, chunk), np.int32)
        fill = np.zeros(s, np.int64)
        for i in range(new.shape[0]):
            si = shard_of[i]
            j = fill[si]
            xb[si, j] = new[i]
            ab[si, j] = local_cl[i]
            vb[si, j] = True
            gids[si, j] = self._n + i
            fill[si] += 1

        # appends always use LOCAL block ids + an id_map (the rerank layout);
        # a global-id index converts on its first append
        self._ensure_id_map(headroom=8 * chunk)

        mesh = self.mesh
        cfg_ = cfg
        specs = jax.tree.map(lambda _: P(SHARD_AXIS), self.state)

        @jax.jit
        def step(state, id_map, xb, ab, vb, gids):
            def local(st, im, xb, ab, vb, gids):
                st0 = jax.tree.map(lambda a: a[0], st)
                base_local = st0.n  # local shadow/id_map offset (= live count)
                st1 = _ivf_append(
                    st0, xb[0], ab[0], vb[0], base_local,
                    cfg_.metric, cfg_.dtype, rerank=bool(cfg_.rerank),
                )
                im0 = jax.lax.dynamic_update_slice(
                    im[0], jnp.where(vb[0], gids[0], -1), (base_local,)
                )
                return jax.tree.map(lambda a: a[None], st1), im0[None]

            return shard_map(
                local, mesh=mesh,
                in_specs=(specs, P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
                          P(SHARD_AXIS), P(SHARD_AXIS)),
                out_specs=(specs, P(SHARD_AXIS)),
            )(state, id_map, xb, ab, vb, gids)

        self.state, self.id_map = step(
            self.state, self.id_map, jnp.asarray(xb), jnp.asarray(ab),
            jnp.asarray(vb), jnp.asarray(gids),
        )
        self._n += new.shape[0]
        self._fns = {}

    def _ensure_id_map(self, headroom: int) -> None:
        """Convert a global-b_ids (non-rerank) index to LOCAL ids + id_map.

        The id_map must be wide enough for appends; the padded append extent
        (dynamic_update_slice clamps OOB starts) drives the headroom."""
        if self.id_map is not None:
            n_loc = np.asarray(self.state.n)
            if int(n_loc.max()) + headroom <= self.id_map.shape[1]:
                return
        s = self.n_shards
        b_ids_host = np.array(self.state.b_ids)   # writable copy
        n_loc = np.asarray(self.state.n)
        rcap = max(1024, -(-(int(n_loc.max()) + headroom) // 1024) * 1024)
        idmap = np.full((s, rcap), -1, np.int32)
        already_local = self.id_map is not None
        old_map = np.asarray(self.id_map) if already_local else None
        for si in range(s):
            if already_local:
                w = min(old_map.shape[1], rcap)
                idmap[si, :w] = old_map[si, :w]
                continue
            enc = b_ids_host[si]
            dec = np.where(enc <= -2, -2 - enc, enc)   # decode tombstones
            sel = dec >= 0                             # live + tombstoned
            glob = dec[sel]
            idmap[si, : glob.size] = glob
            loc = np.full(self._n, -1, np.int64)
            loc[glob] = np.arange(glob.size)
            new_vals = loc[glob]
            # tombstoned slots stay tombstoned in the LOCAL encoding
            new_vals = np.where(enc[sel] <= -2, -2 - new_vals, new_vals)
            b_ids_host[si][sel] = new_vals
        sh = NamedSharding(self.mesh, P(SHARD_AXIS))
        if not already_local:
            self.state = self.state._replace(
                b_ids=jax.device_put(jnp.asarray(b_ids_host), sh),
            )
        if self.cfg.rerank and self.state.rerank_vecs.shape[1] < rcap:
            # grow shadow arrays alongside the map
            rr = np.zeros((s, rcap, self.cfg.dim), np.float32)
            rrn = np.zeros((s, rcap), np.float32)
            rr[:, : self.state.rerank_vecs.shape[1]] = np.asarray(
                self.state.rerank_vecs, np.float32
            )
            rrn[:, : self.state.rerank_norms.shape[1]] = np.asarray(
                self.state.rerank_norms
            )
            rr_dtype = jnp.float32 if self.cfg.rerank_dtype == "float32" else jnp.bfloat16
            self.state = self.state._replace(
                rerank_vecs=jax.device_put(jnp.asarray(rr, rr_dtype), sh),
                rerank_norms=jax.device_put(jnp.asarray(rrn), sh),
            )
        self.id_map = jax.device_put(jnp.asarray(idmap), sh)
        self._fns = {}

    def _reconstruct_global(self, extra_rows: int = 0) -> np.ndarray:
        """All stored vectors in global-id order [n(+extra), D] f32.
        Tombstoned rows are decoded and included (their ids stay occupied)."""
        x_all = np.empty((self._n + extra_rows, self.cfg.dim), np.float32)
        if self.id_map is not None and self.cfg.rerank:
            im = np.asarray(self.id_map)
            rr = np.asarray(self.state.rerank_vecs, np.float32)
            for si in range(self.n_shards):
                sel = im[si] >= 0
                x_all[im[si][sel]] = rr[si][sel]
        else:
            blocks = np.asarray(self.state.blocks, np.float32)
            if self.cfg.dtype == "int8":
                blocks = blocks * np.asarray(self.state.b_scales)[..., None] \
                    + np.asarray(self.state.centroids)[:, :, None, :]
            ids = np.asarray(self.state.b_ids)
            ids = np.where(ids <= -2, -2 - ids, ids)   # decode tombstones
            sel = ids >= 0
            glob = ids[sel]
            if self.id_map is not None:
                im = np.asarray(self.id_map)
                glob = np.concatenate([
                    im[si][ids[si][ids[si] >= 0]] for si in range(self.n_shards)
                ])
            x_all[glob] = blocks[sel]
        return x_all

    def _rebuild_with(self, new: np.ndarray) -> None:
        """Overflow fallback: reconstruct all vectors in global-id order and
        rebuild + re-shard (ids stay stable; tombstones re-marked after)."""
        x_all = self._reconstruct_global(extra_rows=new.shape[0])
        x_all[self._n:] = new
        n_total = self._n + new.shape[0]
        dead = self._dead
        self.build(x_all)
        self._n = n_total
        if dead:
            self._dead = dead
            self._mark_dead(np.asarray(sorted(dead), np.int64))

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
        x_all = self._reconstruct_global()
        self.build(x_all[live])
        return live

    # ------------------------------------------------------------ persistence
    def save(self, path: str) -> None:
        self._flush()
        meta = dict(cfg=dataclasses.asdict(self.cfg), n=self._n,
                    n_shards=self.n_shards)
        arrays = {}
        if self.state is not None:
            for f in IVFState._fields:
                v = np.asarray(getattr(self.state, f))
                if str(v.dtype) == "bfloat16":
                    v = v.astype(np.float32)
                arrays[f] = v
            arrays["c_mask"] = np.asarray(self.c_mask)
            if self.id_map is not None:
                arrays["id_map"] = np.asarray(self.id_map)
            arrays["cent_host"] = self._cent_host
            arrays["cluster_of"] = self._cluster_of
        np.savez_compressed(path, meta=json.dumps(meta), **arrays)

    @classmethod
    def load(cls, path: str, mesh: Optional[Mesh] = None) -> "ShardedIVF":
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            cfg = IVFConfig(**meta["cfg"])
            idx = cls(cfg, mesh=mesh)
            if idx.n_shards != meta["n_shards"]:
                raise ValueError(
                    f"saved with {meta['n_shards']} shards, mesh has {idx.n_shards}"
                )
            idx._n = meta["n"]
            if "centroids" in z:
                sh = NamedSharding(idx.mesh, P(SHARD_AXIS))
                kwargs = {}
                for f in IVFState._fields:
                    v = z[f]
                    if f == "blocks":
                        v = np.asarray(v).astype(cfg.storage_dtype)
                    if f == "rerank_vecs" and cfg.rerank_dtype == "bfloat16":
                        v = np.asarray(v)  # cast on device below
                    kwargs[f] = jax.device_put(jnp.asarray(v), sh)
                if cfg.rerank and cfg.rerank_dtype == "bfloat16":
                    kwargs["rerank_vecs"] = kwargs["rerank_vecs"].astype(jnp.bfloat16)
                idx.state = IVFState(**kwargs)
                idx.c_mask = jax.device_put(jnp.asarray(z["c_mask"]), sh)
                if "id_map" in z:
                    idx.id_map = jax.device_put(jnp.asarray(z["id_map"]), sh)
                idx._cent_host = np.asarray(z["cent_host"])
                idx._cluster_of = np.asarray(z["cluster_of"])
                enc = np.asarray(z["b_ids"])
                if (enc <= -2).any():   # tombstones ride in the encoding
                    _, glob = idx._decoded_slot_globals(enc)
                    idx._dead = set(
                        int(g) for g in glob[(enc <= -2) & (glob >= 0)])
        return idx
