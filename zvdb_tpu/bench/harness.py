"""Benchmark harness mirroring the reference protocol.

Reference protocol (BASELINE.md / benchmarks/shared_benchmarks.zig:4-132):
result schema {operation, num_points, dimensions, num_queries, k, num_threads,
total_time_ns, ops_per_sec}; fresh index per combination; search timing excludes
build. We keep that schema, swap num_threads for num_devices, and add the two
fields the reference never measured: recall@k and ef.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional

import jax
import numpy as np


@dataclasses.dataclass
class BenchmarkResult:
    operation: str
    num_points: int
    dimensions: int
    num_queries: int
    k: int
    num_devices: int
    total_time_ns: int
    ops_per_sec: float
    recall: Optional[float] = None
    ef: Optional[int] = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    def to_csv(self) -> str:
        # reference BenchmarkResult.toCsv (shared_benchmarks.zig:40-49)
        d = dataclasses.asdict(self)
        return ",".join(str(v) for v in d.values())

    def __str__(self) -> str:
        ns = self.total_time_ns
        s = (
            f"{self.operation}: {self.num_points} pts, {self.dimensions}d, "
            f"{self.num_queries} queries, k={self.k}, devices={self.num_devices}: "
            f"{ns/1e6:.1f} ms, {self.ops_per_sec:,.0f} ops/s"
        )
        if self.recall is not None:
            s += f", recall@{self.k}={self.recall:.4f}"
        if self.ef is not None:
            s += f", ef={self.ef}"
        return s


def ground_truth_host(
    x: np.ndarray, q: np.ndarray, k: int, metric: str = "l2", chunk: int = 2048,
    dtype=np.float32,
):
    """Exact kNN on the host via BLAS gemm + argpartition, computed in
    `dtype` (np.float64 for the reference that checks the device oracle).

    Used for recall eval where device compiles would dominate (the on-device
    oracle lives in index/flat.py). Returns (scores, ids) like the flat oracle.
    """
    x = np.ascontiguousarray(x, dtype)
    q = np.ascontiguousarray(q, dtype)
    if metric == "cosine":
        x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    xn = (x * x).sum(1) if metric == "l2" else None
    nq = q.shape[0]
    kk = min(k, x.shape[0])
    ids = np.empty((nq, kk), np.int32)
    scores = np.empty((nq, kk), dtype)
    for lo in range(0, nq, chunk):
        qc = q[lo:lo + chunk]
        dots = qc @ x.T
        s = (xn[None, :] - 2.0 * dots) if metric == "l2" else -dots
        part = np.argpartition(s, kk - 1, axis=1)[:, :kk]
        ps = np.take_along_axis(s, part, axis=1)
        order = np.argsort(ps, axis=1, kind="stable")
        ids[lo:lo + chunk] = np.take_along_axis(part, order, axis=1)
        srt = np.take_along_axis(ps, order, axis=1)
        if metric == "l2":
            srt = srt + (qc * qc).sum(1)[:, None]
        else:
            srt = -srt
        scores[lo:lo + chunk] = srt
    return scores, ids


def recall_at_k(ids: np.ndarray, gt: np.ndarray, k: int) -> float:
    hits = 0
    for r in range(ids.shape[0]):
        hits += len(set(ids[r, :k].tolist()) & set(gt[r, :k].tolist()))
    return hits / (ids.shape[0] * k)


def timeit_sync(fn, *args):
    """Run fn(*args), block until device work completes, return (result, ns)."""
    t0 = time.perf_counter_ns()
    out = fn(*args)
    jax.block_until_ready(out)
    return out, time.perf_counter_ns() - t0


def random_points(rng: np.random.Generator, n: int, dim: int) -> np.ndarray:
    # reference uses uniform random points (shared_benchmarks.zig:53-59)
    return rng.random((n, dim), dtype=np.float32)


def run_insertion_benchmark(index_factory, points: np.ndarray, num_devices=1):
    """Timed bulk build of a fresh index (reference runInsertionBenchmark,
    shared_benchmarks.zig:61-88 — serial inserts there, batched build here)."""
    idx = index_factory()
    t0 = time.perf_counter_ns()
    idx.build(points)
    if idx.state is not None:
        jax.block_until_ready(idx.state)
    ns = time.perf_counter_ns() - t0
    n = points.shape[0]
    return idx, BenchmarkResult(
        operation="insertion",
        num_points=n,
        dimensions=points.shape[1],
        num_queries=0,
        k=0,
        num_devices=num_devices,
        total_time_ns=ns,
        ops_per_sec=n / (ns / 1e9),
    )


def run_search_benchmark(
    idx, queries: np.ndarray, k: int, ef: int, gt: Optional[np.ndarray] = None,
    num_devices=1, warmup: int = 1, batch: Optional[int] = None,
    search_fn=None, reps: int = 4, passes: int = 2,
):
    """Timed batched search (reference runSearchBenchmark,
    shared_benchmarks.zig:90-113; build excluded from timing).

    Query batches are STAGED ON DEVICE before the clock starts and all
    dispatches in a pass are async with one final sync, so the timing
    measures the engine, not host-to-device copies. Serving pipelines keep
    queries device-resident; the reference likewise excludes data
    generation from its timing (shared_benchmarks.zig:101-109). Best of
    `passes` timing passes.

    search_fn(queries, k) overrides the default engine call (used for engines
    whose beam knob isn't called ef_search, e.g. flat approx / ivf nprobe)."""
    import jax.numpy as jnp

    if search_fn is None:
        search_fn = lambda qq, kk: idx.search(qq, kk, ef_search=ef)
    nq = queries.shape[0]
    bs = batch or nq
    staged = [
        jax.device_put(jnp.asarray(queries[lo:lo + bs]))
        for lo in range(0, nq, bs)
    ]
    jax.block_until_ready(staged)
    # warmup triggers compilation
    for _ in range(max(warmup, 1)):
        jax.block_until_ready(search_fn(staged[0], k))
    ids_all = []
    ns = None
    for p in range(max(passes, 1)):
        outs = []
        t0 = time.perf_counter_ns()
        for _ in range(max(reps, 1)):
            for qb in staged:
                outs.append(search_fn(qb, k))
        jax.block_until_ready(outs)
        dt = (time.perf_counter_ns() - t0) // max(reps, 1)
        ns = dt if ns is None else min(ns, dt)
        if p == 0:
            ids_all = [i for (_, i) in outs[: len(staged)]]
    ids = np.concatenate([np.asarray(i) for i in ids_all], axis=0)
    rec = recall_at_k(ids, gt, k) if gt is not None else None
    return ids, BenchmarkResult(
        operation="search",
        num_points=len(idx),
        dimensions=queries.shape[1],
        num_queries=nq,
        k=k,
        num_devices=num_devices,
        total_time_ns=ns,
        ops_per_sec=nq / (ns / 1e9),
        recall=rec,
        ef=ef,
    )
