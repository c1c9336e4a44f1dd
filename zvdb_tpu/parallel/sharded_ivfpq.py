"""Mesh-sharded IVF-PQ: the scale tier over a device mesh.

Clusters are the sharding unit (the expert-parallel analog, same placement
as ShardedIVF: one GLOBAL build — k-means, PQ codebooks, packed code blocks
— then clusters distribute greedily largest-first onto the least-loaded
shard so per-device ADC scan work balances). Each device holds a complete
local IVFPQState over its clusters: packed 4-bit codes, decoded norms,
LOCAL block ids, its clusters' refine rows (dense local-id order) and a
local->global id map. Queries are replicated; every shard probes its own
top `ceil(nprobe/S)+1` local clusters with the grouped ADC scan
(ops/pq_grouped.py:pq_grouped_scan_bins), refines against its LOCAL store
(zero cross-shard gathers), and the per-shard top-k merge is one
all-gather + exact top-k derived from the sharding annotations.

Memory: at the 30M x 96d config (48 nibble codes + int16 refine = 224 B/row)
each device holds 1/S of the rows; the scan cost per device is 1/S of the
single-device engine at matched global nprobe.

Filtered search defaults to the EXACT masked scan over the per-shard refine
stores (parallel/scan_filter.py; probe-pool filtering collapses on
selective filters), filter_mode="probe" keeps the
in-pool filter.

No reference counterpart: the reference is single-address-space
(src/hnsw.zig:6,50); this extends its capability axes across devices
(SURVEY.md §2.3).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..index.ivfpq import (
    IVFPQConfig, IVFPQIndex, IVFPQState, _ivfpq_append, ivfpq_search_impl,
)
from ..ops import distance as D
from ..ops import topk as T
from .mesh import SHARD_AXIS, make_mesh
from .scan_filter import make_sharded_masked_scan
from .mesh import shard_map

INF = jnp.inf


class ShardedIVFPQ:
    """IVF-PQ index with clusters sharded over a device mesh."""

    def __init__(self, cfg: IVFPQConfig, mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_shards = self.mesh.shape[SHARD_AXIS]
        self.state: Optional[IVFPQState] = None   # stacked, leading [S] axis
        self.c_mask = None          # [S, C_loc] bool
        self.id_map = None          # [S, rcap] int32 local -> global
        self._n = 0
        self._fns = {}
        self._scan_fns = {}
        self._pending: list[np.ndarray] = []
        self._cent_host: Optional[np.ndarray] = None   # [C_glob, D]
        self._cluster_of: Optional[np.ndarray] = None  # [C_glob, 2]
        self._owner: Optional[np.ndarray] = None       # [n] global -> shard
        self._lid: Optional[np.ndarray] = None         # [n] global -> local id
        self._n_loc: Optional[np.ndarray] = None       # [S] local live counts
        self._dead: set[int] = set()

    def __len__(self) -> int:
        return (self._n + sum(p.shape[0] for p in self._pending)
                - len(self._dead))

    # ------------------------------------------------------------ construction

    def build(self, x) -> None:
        """One global single-chip build, then cluster distribution. The
        refine store re-shards into per-shard dense local-id order (global
        ids stay dense insertion order; id_map restores them at merge)."""
        if self.cfg.refine == "none":
            raise ValueError(
                "ShardedIVFPQ requires a refine store (the per-shard exact "
                "rerank and the filtered masked scan both read it)")
        single = IVFPQIndex(self.cfg)
        single.build(x)
        st = single.state
        if st is None:
            self.state = None
            self._n = 0
            self._pending = []
            return
        self._n = int(st.n)
        self._pending = []
        self._dead = set()
        s = self.n_shards
        counts = np.asarray(st.counts)
        c = counts.shape[0]

        # greedy size-balanced cluster placement (ShardedIVF.build)
        order = np.argsort(-counts, kind="stable")
        load = np.zeros(s, np.int64)
        members = [[] for _ in range(s)]
        for ci in order:
            tgt = int(np.argmin(load))
            members[tgt].append(ci)
            load[tgt] += counts[ci]
        c_loc = max(max(len(m) for m in members), 1)
        self._cent_host = np.asarray(st.centroids)
        self._cluster_of = np.zeros((c, 2), np.int32)
        for si, m in enumerate(members):
            for li, ci in enumerate(m):
                self._cluster_of[ci] = (si, li)

        def stack(arr, pad_value):
            out = np.full((s, c_loc) + arr.shape[1:], pad_value, arr.dtype)
            for si, m in enumerate(members):
                out[si, : len(m)] = arr[m]
            return out

        cent = stack(np.asarray(st.centroids), 0.0)
        c_norms = stack(np.asarray(st.c_norms), np.inf)  # pad never probed
        codes = stack(np.asarray(st.codes_blocks), 0)
        norms = stack(np.asarray(st.norms_blocks), np.inf)
        b_ids = stack(np.asarray(st.b_ids), -1)          # global ids here
        cnt = stack(counts, 0)
        mask = np.zeros((s, c_loc), bool)
        for si, m in enumerate(members):
            mask[si, : len(m)] = True

        # per-shard refine stores in dense LOCAL id order + local<->global
        refine_np = np.asarray(st.refine)
        scales_np = np.asarray(st.r_scales)
        n_loc = np.asarray([(b_ids[si] >= 0).sum() for si in range(s)],
                           np.int64)
        rcap = max(1024, -(-int(n_loc.max()) // 1024) * 1024 + 1024)
        rr = np.zeros((s, rcap, refine_np.shape[1]), refine_np.dtype)
        rrs = np.ones((s, rcap), np.float32)
        idmap = np.full((s, rcap), -1, np.int32)
        self._owner = np.full(self._n, -1, np.int32)
        self._lid = np.full(self._n, -1, np.int32)
        for si in range(s):
            sel = b_ids[si] >= 0
            glob = np.sort(b_ids[si][sel])
            idmap[si, : glob.size] = glob
            rr[si, : glob.size] = refine_np[glob]
            rrs[si, : glob.size] = scales_np[glob]
            self._owner[glob] = si
            self._lid[glob] = np.arange(glob.size, dtype=np.int32)
            loc = np.full(self._n, -1, np.int64)
            loc[glob] = np.arange(glob.size)
            b_ids[si][sel] = loc[b_ids[si][sel]]

        sh = NamedSharding(self.mesh, P(SHARD_AXIS))
        # codebooks/rot are logically replicated but ride the state tree as
        # per-shard COPIES ([S, ...] leading axis) so every field shares the
        # one P(SHARD_AXIS) spec — they are KB-scale
        cb_s = jnp.broadcast_to(st.codebooks[None],
                                (s,) + st.codebooks.shape)
        rot_s = jnp.broadcast_to(st.rot[None], (s,) + st.rot.shape)
        self.state = IVFPQState(
            centroids=jax.device_put(jnp.asarray(cent), sh),
            c_norms=jax.device_put(jnp.asarray(c_norms), sh),
            codes_blocks=jax.device_put(jnp.asarray(codes), sh),
            norms_blocks=jax.device_put(jnp.asarray(norms), sh),
            b_ids=jax.device_put(jnp.asarray(b_ids), sh),
            counts=jax.device_put(jnp.asarray(cnt), sh),
            codebooks=jax.device_put(cb_s, sh),
            rot=jax.device_put(rot_s, sh),
            refine=jax.device_put(jnp.asarray(rr), sh),
            r_scales=jax.device_put(jnp.asarray(rrs), sh),
            n=jax.device_put(jnp.asarray(n_loc, jnp.int32), sh),
        )
        self.c_mask = jax.device_put(jnp.asarray(mask), sh)
        self.id_map = jax.device_put(jnp.asarray(idmap), sh)
        self._n_loc = n_loc.astype(np.int64)
        self._fns = {}
        self._scan_fns = {}

    # ------------------------------------------------------------------ search

    def _make(self, k: int, nprobe_local: int, rerank: int,
              with_allow: bool):
        cfg = self.cfg
        mesh = self.mesh
        specs = jax.tree.map(lambda _: P(SHARD_AXIS), self.state)

        @jax.jit
        def run(state, c_mask, id_map, allow, q):
            def local(st, cm, im, al, q):
                st = jax.tree.map(lambda a: a[0], st)
                s_, i_ = ivfpq_search_impl(
                    st, q, k, nprobe_local, cfg.metric, cfg.refine, rerank,
                    cfg.l_bins, cfg.chunk, cfg.per_bin, cfg.scan_precision,
                    cfg.group_slack,
                    allowed=al[0] if with_allow else None,
                    id_map=im[0], c_mask=cm[0])
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

    def _sharded_masked_scan(self, q, k: int, av):
        """Exact filtered search: per-shard masked scan over the refine
        stores (scan_filter.py), global merge. av: [n] bool global mask."""
        cfg = self.cfg
        st = self.state
        if k not in self._scan_fns:
            self._scan_fns[k] = make_sharded_masked_scan(
                self.mesh, 1, cfg.metric, "high", k)
        rows = st.refine
        s, rcap = st.r_scales.shape
        if cfg.refine in ("int8", "int16"):
            rf = rows.astype(jnp.float32)
            rn = (st.r_scales ** 2 * jnp.sum(rf * rf, axis=-1)
                  if cfg.metric == "l2"
                  else jnp.zeros((s, rcap), jnp.float32))
            scl = st.r_scales
        else:
            rf = rows.astype(jnp.float32)
            rn = (jnp.sum(rf * rf, axis=-1) if cfg.metric == "l2"
                  else jnp.zeros((s, rcap), jnp.float32))
            scl = jnp.ones((s, rcap), jnp.float32)
        ok = jnp.take(av, jnp.maximum(self.id_map, 0)) & (self.id_map >= 0)
        bias = jnp.where(ok, 0.0, INF)
        return self._scan_fns[k](rows, rn + bias, scl, self.id_map, q)

    def search(self, q, k: int, nprobe: Optional[int] = None,
               rerank: Optional[int] = None, allowed=None,
               filter_mode: str = "auto"):
        """Shard-routed top-k. `nprobe` is a GLOBAL budget: each shard
        probes its ceil(nprobe/S)+1 best LOCAL clusters (the ShardedIVF
        convention — the union covers at least the single-chip probe set's
        per-shard share and usually widens it, so recall at a matched
        budget is >= the single-chip row). Filtered search defaults to the
        exact masked scan over the refine stores; "auto" routes
        near-all-pass filters on huge corpora to "probe"
        (utils/filter_policy.py)."""
        if filter_mode not in ("auto", "scan", "probe"):
            raise ValueError(f"invalid filter_mode {filter_mode!r}")
        self._flush()
        if filter_mode == "auto":
            from ..utils.filter_policy import resolve_filter_mode

            filter_mode = resolve_filter_mode(
                "auto", allowed, self._n, alt="probe")
        q = jnp.atleast_2d(jnp.asarray(q, jnp.float32))
        if q.shape[-1] != self.cfg.dim:
            raise ValueError(
                f"dimension mismatch: index dim {self.cfg.dim}, "
                f"got {q.shape[-1]}")
        if self.state is None or self._n == 0:
            return (
                jnp.full((q.shape[0], k),
                         INF if self.cfg.metric == "l2" else -INF),
                jnp.full((q.shape[0], k), -1, jnp.int32),
            )
        av = None
        if allowed is not None:
            # dead rows fold into the allow mask here; the unfiltered probe
            # path excludes them via the -2-id b_ids tombstones (_mask_dead)
            from ..utils.masks import allowed_mask

            av = allowed_mask(allowed, self._n, self._n)
            if self._dead:
                dead = np.fromiter(self._dead, np.int64, len(self._dead))
                av = av.at[jnp.asarray(dead)].set(False)
        if allowed is not None and filter_mode == "scan":
            return self._sharded_masked_scan(q, k, av)
        p = min(nprobe or self.cfg.nprobe, int(self._cluster_of.shape[0]))
        p_loc = min(-(-p // self.n_shards) + 1, self.state.c_norms.shape[1])
        rr = ((rerank if rerank is not None else self.cfg.rerank)
              * (8 if av is not None else 1))
        key = (k, p_loc, rr, av is not None)
        if key not in self._fns:
            self._fns[key] = self._make(*key)
        allow_arg = av
        if av is None:
            allow_arg = jnp.zeros((1,), bool)      # placeholder, never read
        # per-shard LOCAL allow mask (impl filters on LOCAL block ids)
        if av is not None:
            allow_arg = (jnp.take(av, jnp.maximum(self.id_map, 0))
                         & (self.id_map >= 0))
        else:
            allow_arg = jnp.broadcast_to(
                allow_arg[None, :], (self.n_shards, 1))
        return self._fns[key](self.state, self.c_mask, self.id_map,
                              allow_arg, q)

    # ------------------------------------------------------------------ insert

    def add(self, x) -> None:
        """Buffered append; routed to the owning shard of each row's nearest
        global centroid (codebooks + centroids frozen — the single-chip
        contract). Global ids stay dense insertion order."""
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
        cfg = self.cfg
        if cfg.metric == "cosine":
            new = new / np.maximum(
                np.linalg.norm(new, axis=1, keepdims=True), 1e-12)
        s = self.n_shards
        base = self._n
        # global centroid routing on the host copy (centroids are KB-scale)
        cent = jnp.asarray(self._cent_host)
        cn = D.sq_norms(cent)
        glob_assign = np.concatenate([
            np.asarray(jnp.argmin(D.pairwise_scores(
                jnp.asarray(new[lo:lo + 16384]), cent, cn, cfg.metric),
                axis=-1))
            for lo in range(0, new.shape[0], 16384)
        ]) if new.shape[0] else np.zeros((0,), np.int64)
        shard_of = self._cluster_of[glob_assign, 0]
        local_c = self._cluster_of[glob_assign, 1]

        # overflow checks: per-(shard, local cluster) capacity + refine cap
        st = self.state
        cap = st.codes_blocks.shape[3]
        rcap = st.refine.shape[1]
        cnt = np.asarray(st.counts)
        addc = np.zeros_like(cnt)
        np.add.at(addc, (shard_of, local_c), 1)
        per_shard_new = np.bincount(shard_of, minlength=s)
        if (int((cnt + addc).max()) > cap
                or int((self._n_loc + per_shard_new).max()) > rcap):
            self._rebuild_with(new)
            return

        per = max(8, int(per_shard_new.max()))
        xb = np.zeros((s, per, cfg.dim), np.float32)
        ab = np.zeros((s, per), np.int32)
        vb = np.zeros((s, per), bool)
        gids = np.full((s, per), -1, np.int32)
        fill = np.zeros(s, np.int64)
        for i in range(new.shape[0]):
            si = shard_of[i]
            j = fill[si]
            xb[si, j] = new[i]
            ab[si, j] = local_c[i]
            vb[si, j] = True
            gids[si, j] = base + i
            fill[si] += 1
        ext0 = self._n_loc.astype(np.int32)

        sh = NamedSharding(self.mesh, P(SHARD_AXIS))
        specs = jax.tree.map(lambda _: P(SHARD_AXIS), st)

        @jax.jit
        def step(state, xb, ab, vb, e0):
            def local(st, xb, ab, vb, e0):
                st = jax.tree.map(lambda a: a[0], st)
                out = _ivfpq_append.__wrapped__(
                    st, xb[0], ab[0], vb[0], e0[0, 0],
                    cfg.metric, cfg.refine)
                return jax.tree.map(lambda a: a[None], out)

            return shard_map(
                local, mesh=self.mesh,
                in_specs=(specs, P(SHARD_AXIS), P(SHARD_AXIS),
                          P(SHARD_AXIS), P(SHARD_AXIS)),
                out_specs=specs,
            )(state, xb, ab, vb, e0)

        self.state = step(
            st, jax.device_put(jnp.asarray(xb), sh),
            jax.device_put(jnp.asarray(ab), sh),
            jax.device_put(jnp.asarray(vb), sh),
            jax.device_put(jnp.asarray(ext0[:, None]), sh))
        # host-side maps: local ids are dense per shard in routed order
        new_owner = shard_of.astype(np.int32)
        new_lid = np.zeros(new.shape[0], np.int32)
        fill = self._n_loc.copy()
        idmap = np.array(self.id_map)   # mutable host copy
        for i in range(new.shape[0]):
            si = shard_of[i]
            new_lid[i] = fill[si]
            idmap[si, fill[si]] = base + i
            fill[si] += 1
        self._owner = np.concatenate([self._owner, new_owner])
        self._lid = np.concatenate([self._lid, new_lid])
        self._n_loc = fill
        self.id_map = jax.device_put(jnp.asarray(idmap), sh)
        self._n += new.shape[0]

    def _reconstruct_global(self) -> np.ndarray:
        """Live vectors in global-id order (dequantized refine store)."""
        st = self.state
        rows = np.asarray(st.refine).astype(np.float32)
        if self.cfg.refine in ("int8", "int16"):
            rows = rows * np.asarray(st.r_scales)[:, :, None]
        out = np.zeros((self._n, self.cfg.dim), np.float32)
        sel = self._owner >= 0
        out[np.flatnonzero(sel)] = rows[self._owner[sel], self._lid[sel]]
        return out

    def _rebuild_with(self, new: np.ndarray) -> None:
        """Overflow fallback: full rebuild from reconstructed vectors.
        Ids stay stable (global ids are dense insertion order; tombstones
        survive as masked rows)."""
        dead = self._dead
        x_all = np.concatenate([self._reconstruct_global(), new], axis=0)
        self.build(x_all)
        if dead:
            self._dead = dead
            self._mask_dead()

    # ---------------------------------------------------------------- mutation

    def _mask_dead(self) -> None:
        """Flip tombstoned rows' block entries to the -2-id encoding (every
        scan masks b_ids >= 0) — probe path; the masked-scan path filters
        through the id_map allow bias in search()."""
        if not self._dead:
            return
        dead = np.fromiter(self._dead, np.int64, len(self._dead))
        grid = np.array(self.state.b_ids)   # mutable host copy
        lids = self._lid[dead]
        owners = self._owner[dead]
        sh = NamedSharding(self.mesh, P(SHARD_AXIS))
        for si in np.unique(owners):
            want = lids[owners == si]
            cc, ss_ = np.nonzero(np.isin(grid[si], want))
            grid[si, cc, ss_] = -2 - grid[si, cc, ss_]
        self.state = self.state._replace(
            b_ids=jax.device_put(jnp.asarray(grid), sh))

    def remove(self, ids) -> int:
        """Tombstone by global id (mark-and-filter; ids never renumber).
        Returns the number of rows newly deleted."""
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
        self._mask_dead()
        return int(new.size)

    def compact(self) -> np.ndarray:
        """Drop tombstones; survivors renumber to [0, L) in former
        global-id order. Returns the survivors' old ids (rebuild — builds
        are cheap here, the family contract)."""
        self._flush()
        alive = np.ones(self._n, bool)
        if self._dead:
            alive[np.fromiter(self._dead, np.int64, len(self._dead))] = False
        live = np.flatnonzero(alive)
        if self.state is None or not self._dead:
            self._dead = set()
            return live
        x = self._reconstruct_global()[live]
        self.build(x)
        return live

    # ------------------------------------------------------------------- reads

    def get(self, ids) -> np.ndarray:
        """Stored (dequantized refine) representation for global ids."""
        self._flush()
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        if ids.size == 0:
            return np.zeros((0, self.cfg.dim), np.float32)
        if (ids < 0).any() or (ids >= self._n).any():
            raise IndexError(f"ids must be in [0, {self._n})")
        if self._dead and any(int(i) in self._dead for i in ids):
            raise IndexError("id was deleted")
        rows = np.asarray(self.state.refine)[
            self._owner[ids], self._lid[ids]].astype(np.float32)
        if self.cfg.refine in ("int8", "int16"):
            rows = rows * np.asarray(self.state.r_scales)[
                self._owner[ids], self._lid[ids]][:, None]
        return rows

    # ------------------------------------------------------------- persistence

    def save(self, path: str) -> None:
        self._flush()
        meta = dict(cfg=dataclasses.asdict(self.cfg), n=self._n,
                    n_shards=self.n_shards,
                    n_loc=[int(v) for v in self._n_loc],
                    dead=sorted(int(i) for i in self._dead))
        arrays = {
            f"st_{f}": np.asarray(getattr(self.state, f))
            for f in self.state._fields
        }
        arrays["c_mask"] = np.asarray(self.c_mask)
        arrays["id_map"] = np.asarray(self.id_map)
        arrays["cent_host"] = self._cent_host
        arrays["cluster_of"] = self._cluster_of
        arrays["owner"] = self._owner
        arrays["lid"] = self._lid
        np.savez_compressed(path, meta=json.dumps(meta), **arrays)

    @classmethod
    def load(cls, path: str, mesh: Optional[Mesh] = None) -> "ShardedIVFPQ":
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            cfg = IVFPQConfig(**meta["cfg"])
            idx = cls(cfg, mesh=mesh)
            if idx.n_shards != meta["n_shards"]:
                raise ValueError(
                    f"saved with {meta['n_shards']} shards, "
                    f"mesh has {idx.n_shards}")
            sh = NamedSharding(idx.mesh, P(SHARD_AXIS))
            fields = {}
            for f in IVFPQState._fields:
                a = jnp.asarray(z[f"st_{f}"])
                if f == "refine":
                    a = a.astype(cfg.refine_dtype)
                fields[f] = jax.device_put(a, sh)
            idx.state = IVFPQState(**fields)
            idx.c_mask = jax.device_put(jnp.asarray(z["c_mask"]), sh)
            idx.id_map = jax.device_put(jnp.asarray(z["id_map"]), sh)
            idx._cent_host = np.asarray(z["cent_host"])
            idx._cluster_of = np.asarray(z["cluster_of"])
            idx._owner = np.asarray(z["owner"])
            idx._lid = np.asarray(z["lid"])
            idx._n = int(meta["n"])
            idx._n_loc = np.asarray(meta["n_loc"], np.int64)
            idx._dead = set(meta["dead"])
        return idx
