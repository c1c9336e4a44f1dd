#!/usr/bin/env python
"""Headline benchmark: QPS at recall@10 >= 0.95, 100k x 128d SIFT-like corpus.

Workload: the reference's measured configuration (100k points, 128d, 10k
queries, k=10 — BASELINE.md "Measured"; reference: 2,678.13 QPS / 8,392 inserts
per second, single-threaded CPU). Data is the SIFT1M synthetic stand-in
(clustered Gaussian mixture — real SIFT is used automatically if fvecs files
are present under $ZVDB_DATA; this machine is air-gapped).

Engines measured (all part of zvdb-tpu):
  flat   — brute force: dense matmul scoring + approx top-k (exact
           scoring, selection recall >= target). The headline engine.
  ivf    — cluster-blocked inverted file (split-balanced k-means).
  hnsw   — reference-parity graph engine (hierarchical beam search; bulk
           build is the all-matmul oneshot cluster-kNN construction).
  cagra  — single-layer fixed-degree graph, centroid-seeded beam, packed
           one-gather scoring rows (the fast graph engine).
  pq     — product-quantized scan + int16 refine rerank (measured at the 1M
           config only: the memory-scaling engine, 12 B/vec codes).
  ivfpq  — cluster-blocked 4-bit PQ + grouped ADC scan (the sublinear
           scale tier: scans only probed clusters; measured at 1M).

Graph-engine builds are timed WARM (same-shape rebuild after a first build
that pays the one-off XLA compilations — the reference's Zig build has no
compile stage to amortize, and its search timing convention likewise excludes
setup; benchmarks/shared_benchmarks.zig:90-113).

Reporting: the cumulative result JSON line is emitted after EVERY completed
section — the last complete line wins, so a run cut by a time limit still
leaves a parseable snapshot. Search QPS is best-of-2 with both per-run
samples recorded (qps_runs), matching the builds' discipline. The process
exits nonzero if any section failed. Every result line names the device.

Run: python bench.py   (one process per card; ZVDB_BENCH_SMOKE=1 for tiny
shapes on the CPU, a flow check only)
"""
import json
import os
import sys
import time

import numpy as np

REFERENCE_QPS = 2678.13      # BASELINE.md measured search throughput
REFERENCE_BUILD = 8392.22    # BASELINE.md measured insert throughput
TARGET_RECALL = 0.95
# exact ground truth is cached in the checkout (git-ignored), keyed by shape
# and a corpus fingerprint
GT_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".cache",
                        "gt")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


FAILED: list = []


def fail(section: str, e: Exception) -> None:
    """Log a failed section; the run goes on and exits nonzero at the end."""
    log(f"{section} failed: {e!r}")
    FAILED.append(section)


def timed_qps(search_fn, q, batch, reps=6):
    """Amortized wall-clock QPS: dispatch `reps` full passes asynchronously,
    sync once, so per-rep host syncs do not understate large-batch
    throughput. Query batches are staged on-device first (serving pipelines
    keep queries device-resident). Best of two timing passes with BOTH
    samples returned.

    Returns (best_qps, [run1_qps, run2_qps])."""
    import jax
    import jax.numpy as jnp

    staged = [
        jax.device_put(jnp.asarray(q[lo:lo + batch]))
        for lo in range(0, q.shape[0], batch)
    ]
    jax.block_until_ready(staged)
    runs = []
    for _pass in range(2):
        outs = []
        t0 = time.perf_counter()
        for _ in range(reps):
            for qb in staged:
                outs.append(search_fn(qb))
        jax.block_until_ready(outs)
        dt = time.perf_counter() - t0
        runs.append(round(reps * q.shape[0] / dt, 1))
    return max(runs), runs


def emit(results):
    """Print the cumulative machine-readable result line (stdout, flushed).

    Called after every completed section so a driver timeout mid-run still
    leaves the last complete snapshot parseable; the final call is the full
    result. Headline = best 100k-protocol engine clearing the recall target
    (1M/scale rows are reported alongside in `engines`)."""
    results_100k = {k2: v2 for k2, v2 in results.items() if "_" not in k2}
    pool = results_100k or results
    best_name, best = max(
        ((name, r) for name, r in pool.items()
         if r["recall"] >= TARGET_RECALL),
        key=lambda kv: kv[1]["qps"],
        default=(None, None),
    )
    if best is None:
        best_name, best = max(pool.items(), key=lambda kv: kv[1]["recall"])

    # build_pps is the device-resident number for the ivf/graph engines
    # (the reference's own protocol times inserts with data already in
    # RAM); build_pps_hostcorpus keeps the host-to-device upload in (flat's
    # ingest IS the upload, so flat reports the host number as build_pps).
    import jax

    dev = jax.devices()[0]
    out = {
        "metric": "qps_at_recall0.95@10_100k_128d_sift_like",
        "value": round(best["qps"], 1),
        "unit": "qps",
        "vs_baseline": round(best["qps"] / REFERENCE_QPS, 2),
        "engine": best_name,
        "recall": round(best["recall"], 4),
        "build_pts_per_sec": round(best["build_pps"], 1),
        "build_pts_per_sec_hostcorpus": round(
            best.get("build_pps_hostcorpus", best["build_pps"]), 1),
        "build_vs_baseline": round(best["build_pps"] / REFERENCE_BUILD, 2),
        "build_hostcorpus_vs_baseline": round(
            best.get("build_pps_hostcorpus", best["build_pps"])
            / REFERENCE_BUILD, 2),
        "engines": {k2: {k3: (round(v3, 4) if isinstance(v3, float) else v3)
                         for k3, v3 in v2.items()} for k2, v2 in results.items()},
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    print(json.dumps(out), flush=True)


def corpus_1m(d, nq, k, n1=1_000_000):
    """1M corpus + SELF-CONTAINED query stream + cached exact GT.

    The query rng is its own stream (seed 777), NOT a continuation of the
    100k section's — section reordering must never silently invalidate the
    GT cache (a cache keyed by shape alone once served stale ground truth
    and read recall 0.0001). The cache name carries a corpus fingerprint."""
    import jax

    from zvdb_tpu import FlatConfig, FlatIndex
    from zvdb_tpu.io.datasets import synthetic_clustered

    x1 = synthetic_clustered(n1, d, n_clusters=min(10_000, n1 // 10), seed=0)
    qrng = np.random.default_rng(777)
    q1 = (x1[qrng.integers(0, n1, nq)]
          + 0.05 * qrng.standard_normal((nq, d))).astype(np.float32)
    fp = int(abs(float(x1[::9973].sum())) * 997) % 10**9
    gt1_cache = os.path.join(GT_CACHE, f"gt1m_v3_{n1}_{d}_{nq}_{k}_{fp}.npz")
    if os.path.exists(gt1_cache):
        gt1 = np.load(gt1_cache)["gt"]
    else:
        oracle = FlatIndex(
            FlatConfig(dim=d, precision="highest", tile_n=262144),
            capacity=n1)
        oracle.add(x1)
        gt1 = np.concatenate([
            np.asarray(oracle.search(q1[lo:lo + 2048], k)[1])
            for lo in range(0, nq, 2048)
        ])
        np.savez(gt1_cache, gt=gt1)
        del oracle
    return x1, q1, gt1


def run_pq_scale(scale_n: int, k: int = 10, engine: str = "pq"):
    """>=30M single-chip scale row (the 100M-config hardware evidence).

    Chunked DEEP-like 96d build with exact GT merged per resident chunk,
    so the whole corpus never sits on the device next to its index. Returns
    (results key, row dict). Small scale_n values run the same code as a
    smoke (chunk shrinks to scale_n). engine: "pq" (flat 4-bit scan,
    linear in N) or "ivfpq" (cluster-blocked probes, the sublinear tier).
    """
    import jax

    from zvdb_tpu import (FlatConfig, FlatIndex, IVFPQConfig, IVFPQIndex,
                          PQConfig, PQFlatIndex)
    from zvdb_tpu.bench.harness import recall_at_k

    ds, nqs = 96, 2048
    chunk_n = min(2_000_000, scale_n)   # small values = smoke mode
    # int16 refine store: f32-grade rescoring at 224 B/row at 96d.
    if engine == "ivfpq":
        # the sublinear tier: probed cluster blocks cut the linear ADC scan
        # ~C/nprobe-fold; expected_rows pre-sizes blocks + refine so chunked
        # adds never repack.
        sidx = IVFPQIndex(IVFPQConfig(
            dim=ds, n_sub=48, refine="int16", nprobe=16, rerank=16,
            l_bins=256, chunk=512, train_sample=min(131072, chunk_n),
            expected_rows=scale_n))
    else:
        sidx = PQFlatIndex(PQConfig(
            dim=ds, n_sub=48, n_codes=16, refine="int16", rerank=16,
            train_sample=min(131072, chunk_n)), capacity=scale_n)
    cents = (np.random.default_rng(4242)
             .standard_normal((32768, ds)).astype(np.float32) * 2.0)

    def s_chunk(i, rows):
        r = np.random.default_rng(9000 + i)
        a = r.integers(0, 32768, rows)
        return (cents[a]
                + 0.25 * r.standard_normal((rows, ds)).astype(np.float32))

    qrng = np.random.default_rng(555)
    c0 = s_chunk(0, chunk_n)
    qs_ = (c0[qrng.integers(0, chunk_n, nqs)]
           + 0.12 * qrng.standard_normal((nqs, ds))).astype(np.float32)
    qsd = jax.device_put(qs_)
    gs = np.full((nqs, k), np.inf, np.float32)
    gi = np.full((nqs, k), -1, np.int64)
    t0 = time.perf_counter()
    for i in range(scale_n // chunk_n):
        xc = c0 if i == 0 else s_chunk(i, chunk_n)
        xdc = jax.device_put(xc)
        jax.block_until_ready(xdc)
        if engine == "ivfpq" and i == 0:
            sidx.build(xdc)          # trains centroids + codebooks
        else:
            sidx.add(xdc)
            if engine == "ivfpq":
                sidx.flush()         # append into pre-sized cluster blocks
        orc = FlatIndex(FlatConfig(dim=ds, precision="highest",
                                   tile_n=250_000), capacity=chunk_n)
        orc.add(xdc)
        s_c, i_c = (np.asarray(v) for v in orc.search(qsd, k))
        del orc, xdc, xc
        alls = np.concatenate([gs, s_c], axis=1)
        alli = np.concatenate(
            [gi, i_c.astype(np.int64) + i * chunk_n], axis=1)
        pos = np.argsort(alls, axis=1, kind="stable")[:, :k]
        gs = np.take_along_axis(alls, pos, axis=1)
        gi = np.take_along_axis(alli, pos, axis=1)
    sb = time.perf_counter() - t0
    # deeper rerank at scale: the refine pool must grow with N
    if engine == "ivfpq":
        rr = 32 if scale_n >= 8_000_000 else 16
        fn = lambda qq: sidx.search(qq, k, nprobe=16, rerank=rr)
    else:
        rr = 128 if scale_n >= 8_000_000 else 16
        fn = lambda qq: sidx.search(qq, k, rerank=rr)
    ids_s = np.asarray(fn(qsd)[1])
    rs_ = recall_at_k(ids_s, gi, k)
    qps_s, qps_s_runs = timed_qps(fn, qs_, 2048)
    log(f"{engine} scale {scale_n:,}: recall={rs_:.4f} qps={qps_s:,.0f} "
        f"build={scale_n/sb:,.0f} pts/s (incl. exact-GT pass)")
    return (f"{engine}_{scale_n // 1_000_000}m",
            dict(recall=rs_, qps=qps_s, qps_runs=qps_s_runs,
                 build_pps=scale_n / sb))


def main():
    import jax

    from zvdb_tpu.utils.cache import setup_compile_cache
    setup_compile_cache()

    from zvdb_tpu import (
        FlatConfig, FlatIndex, HNSW, HNSWConfig, IVFConfig, IVFIndex,
    )
    from zvdb_tpu.bench.harness import ground_truth_host, recall_at_k
    from zvdb_tpu.io.datasets import load_dataset

    # ZVDB_BENCH_SMOKE=1: tiny shapes for a CPU flow check (section ordering,
    # per-section JSON emission, engine plumbing) — NOT a performance run.
    smoke = bool(int(os.environ.get("ZVDB_BENCH_SMOKE", "0")))
    n, d, nq, k = (20_000, 128, 2_000, 10) if smoke else \
        (100_000, 128, 10_000, 10)
    x, q, _, metric = load_dataset("sift1m", max_rows=n)
    q = q[:nq]
    rng = np.random.default_rng(9)
    # query workload: perturbed corpus points (matches ANN-benchmark style
    # query/corpus correlation; pure random queries have no near neighbors)
    q = (x[rng.integers(0, n, nq)]
         + 0.05 * rng.standard_normal((nq, d))).astype(np.float32)

    log(f"backend={jax.default_backend()} devices={jax.devices()}")
    # absorb the per-process device-init cost before anything is timed
    import jax.numpy as jnp
    t0 = time.time()
    _ = float((jnp.ones((8, 128)) @ jnp.ones((128, 8))).sum())
    log(f"device init {time.time()-t0:.1f}s")
    os.makedirs(GT_CACHE, exist_ok=True)
    gt_cache = os.path.join(GT_CACHE, f"gt_clustered_{n}_{d}_{nq}_{k}.npz")
    t0 = time.time()
    if os.path.exists(gt_cache):
        gt = np.load(gt_cache)["gt"]
    else:
        _, gt = ground_truth_host(x, q, k, metric)
        np.savez(gt_cache, gt=gt)
    log(f"ground truth in {time.time()-t0:.1f}s")

    results = {}

    # ---- flat: exact matmul scoring + approx top-k ------------------------
    # precision "high" (ops/distance.py says what it lowers to). Plain bf16
    # ("default") craters recall on clustered data — do not use it for
    # scoring. Every build is best-of-2 with both samples recorded
    # (build_runs_pps).
    flat_cfg = FlatConfig(dim=d, metric=metric, precision="high",
                          recall_target=0.97, tile_n=131072)
    flat_build_s, flat_build_runs = float("inf"), []
    for _ in range(2):
        flat = FlatIndex(flat_cfg, capacity=n)
        t0 = time.perf_counter()
        flat.add(x)
        jax.block_until_ready(flat.state)
        dt = time.perf_counter() - t0
        flat_build_runs.append(round(n / dt, 1))
        flat_build_s = min(flat_build_s, dt)
    # one batch = one dispatch per pass: a 10k+1808-style remainder batch costs
    # an extra compile AND worse device utilization
    batch = nq
    ids = []
    for lo in range(0, nq, batch):
        ids.append(np.asarray(flat.search(q[lo:lo + batch], k, approx=True)[1]))
    flat_recall = recall_at_k(np.concatenate(ids), gt, k)
    flat_qps, flat_qps_runs = timed_qps(
        lambda qq: flat.search(qq, k, approx=True), q, batch)
    log(f"flat: recall={flat_recall:.4f} qps={flat_qps:,.0f} build={n/flat_build_s:,.0f} pts/s")
    results["flat"] = dict(recall=flat_recall, qps=flat_qps,
                           qps_runs=flat_qps_runs,
                           build_pps=n / flat_build_s,
                           build_runs_pps=flat_build_runs)
    del flat
    emit(results)

    # ---- the 1M rows (pq_1m, ivfpq_1m, cagra_1m) ---------------------------
    x1 = q1 = gt1 = None
    n1 = 60_000 if smoke else 1_000_000
    try:
        x1, q1, gt1 = corpus_1m(d, nq, k, n1)
        log("1M corpus + gt ready")
    except Exception as e:
        fail("1M corpus", e)

    # ---- PQ at 1M: the memory-scaling engine (codes 8 B/vec + int16 refine
    # store vs 512 B f32 — the BASELINE config-5 memory lever) ---------------
    if x1 is not None:
        try:
            from zvdb_tpu import PQConfig, PQFlatIndex

            # the PQConfig defaults: 4-bit ns16 codes, XLA decode-tile scan,
            # int16 refine store, rerank=12 — 272 B/row vs flat's 512
            pq_cfg = PQConfig(dim=d, metric=metric)
            xd1 = jax.device_put(x1)
            jax.block_until_ready(xd1)
            warm = PQFlatIndex(pq_cfg)
            warm.build(xd1)                    # pays the one-off compiles
            jax.block_until_ready(warm.state)
            del warm
            pq_build_dev_s, pq_runs = float("inf"), []
            for _ in range(2):
                pqi = PQFlatIndex(pq_cfg)
                t0 = time.perf_counter()
                pqi.build(xd1)
                jax.block_until_ready(pqi.state)
                dt = time.perf_counter() - t0
                pq_runs.append(round(n1 / dt, 1))
                pq_build_dev_s = min(pq_build_dev_s, dt)
            del xd1
            idsq = np.concatenate([
                np.asarray(pqi.search(q1[lo:lo + 2048], k)[1])
                for lo in range(0, nq, 2048)
            ])
            rq_ = recall_at_k(idsq, gt1, k)
            qpsq, qpsq_runs = timed_qps(
                lambda qq: pqi.search(qq, k), q1, 2048)
            log(f"pq 1M: recall={rq_:.4f} qps={qpsq:,.0f} "
                f"build={n1/pq_build_dev_s:,.0f} pts/s device-resident "
                f"(codes+refine {pq_cfg.bytes_per_vector * n1 / 2**30:.2f} GB "
                f"vs {4 * d * n1 / 2**30:.1f} GB f32)")
            results["pq_1m"] = dict(recall=rq_, qps=qpsq, qps_runs=qpsq_runs,
                                    build_pps=n1 / pq_build_dev_s,
                                    build_runs_pps=pq_runs)
            del pqi
        except Exception as e:
            fail("pq 1M", e)
        emit(results)

    # ---- IVF-PQ at 1M: the sublinear scale tier. Same 4-bit codes + int16
    # refine as pq_1m, but cluster-blocked so each query scans only its
    # probed clusters via the grouped ADC scan (ops/pq_grouped.py). nprobe=8,
    # rerank=12 (not yet tuned on the H100). ---------------------------------
    if x1 is not None:
        try:
            from zvdb_tpu import IVFPQConfig, IVFPQIndex

            ipq_cfg = IVFPQConfig(dim=d, metric=metric)
            xd1 = jax.device_put(x1)
            jax.block_until_ready(xd1)
            warm = IVFPQIndex(ipq_cfg)
            warm.build(xd1)                    # pays the one-off compiles
            jax.block_until_ready(warm.state.codes_blocks)
            del warm
            ipq_build_dev_s, ipq_runs = float("inf"), []
            for _ in range(2):
                ipq = IVFPQIndex(ipq_cfg)
                t0 = time.perf_counter()
                ipq.build(xd1)
                jax.block_until_ready(ipq.state.codes_blocks)
                dt = time.perf_counter() - t0
                ipq_runs.append(round(n1 / dt, 1))
                ipq_build_dev_s = min(ipq_build_dev_s, dt)
            del xd1
            npb, rrb = 8, 12
            idsi = np.concatenate([
                np.asarray(ipq.search(q1[lo:lo + 2048], k,
                                      nprobe=npb, rerank=rrb)[1])
                for lo in range(0, nq, 2048)
            ])
            ri_ = recall_at_k(idsi, gt1, k)
            qpsi, qpsi_runs = timed_qps(
                lambda qq: ipq.search(qq, k, nprobe=npb, rerank=rrb),
                q1, 2048)
            log(f"ivfpq 1M: recall={ri_:.4f} qps={qpsi:,.0f} "
                f"build={n1/ipq_build_dev_s:,.0f} pts/s device-resident "
                f"({ipq_cfg.bytes_per_vector * n1 / 2**30:.2f} GB)")
            results["ivfpq_1m"] = dict(recall=ri_, qps=qpsi,
                                       qps_runs=qpsi_runs,
                                       build_pps=n1 / ipq_build_dev_s,
                                       build_runs_pps=ipq_runs,
                                       nprobe=npb, rerank=rrb)
            del ipq
        except Exception as e:
            fail("ivfpq 1M", e)
        emit(results)

    # ---- graph engine at 1M ------------------------------------------------
    if x1 is not None:
        try:
            from zvdb_tpu import CagraConfig, CagraIndex

            def cg1_factory():
                # ef=12 sd=24 mi=4 @ anchors=262144 (not yet tuned on the
                # H100). Anchors cut beam hops (each a row gather); the seed
                # matmul is cheap.
                return CagraIndex(CagraConfig(
                    dim=d, degree=32, metric=metric,
                    n_anchors=min(262144, n1 // 4),
                    search_degree=24, max_iters=4, ef_search=12))

            cg1 = cg1_factory()          # pays the one-off 1M-shape compiles
            cg1.build(x1)
            jax.block_until_ready(cg1.state)
            t0 = time.perf_counter()     # warm host-corpus rebuild
            cg1 = cg1_factory()
            cg1.build(x1)
            jax.block_until_ready(cg1.state)
            cb1 = time.perf_counter() - t0
            # device-resident 1M build
            xd1 = jax.device_put(x1)
            jax.block_until_ready(xd1)
            cb1_dev, cg1_dev_runs = float("inf"), []
            for _ in range(2):
                cgd = cg1_factory()
                t0 = time.perf_counter()
                cgd.build(xd1)
                jax.block_until_ready(cgd.state)
                dt = time.perf_counter() - t0
                cg1_dev_runs.append(round(n1 / dt, 1))
                cb1_dev = min(cb1_dev, dt)
            del cgd, xd1
            idsg = np.concatenate([
                np.asarray(cg1.search(q1[lo:lo + 5000], k, ef_search=12)[1])
                for lo in range(0, nq, 5000)
            ])
            rg = recall_at_k(idsg, gt1, k)
            qpsg, qpsg_runs = timed_qps(
                lambda qq: cg1.search(qq, k, ef_search=12), q1, 5000, reps=3)
            log(f"cagra 1M: recall={rg:.4f} qps={qpsg:,.0f} "
                f"build={n1/cb1_dev:,.0f} pts/s device-resident "
                f"(host-corpus {n1/cb1:,.0f})")
            results["cagra_1m"] = dict(recall=rg, qps=qpsg,
                                       qps_runs=qpsg_runs,
                                       build_pps=n1 / cb1_dev,
                                       build_pps_hostcorpus=n1 / cb1, ef=12,
                                       build_runs_pps=cg1_dev_runs)
            del cg1
        except Exception as e:
            fail("cagra 1M", e)
        emit(results)

    # ---- ivf (100k protocol) ------------------------------------------------
    # kmeans_iters=4 / sample=65536 (not yet tuned on the H100)
    try:
        ivf_cfg = IVFConfig(dim=d, n_clusters=1024, nprobe=8, metric=metric,
                            kmeans_iters=4, kmeans_sample=65536)
        warm = IVFIndex(ivf_cfg)
        warm.build(x)                      # pays the one-off compiles
        jax.block_until_ready(warm.state)
        del warm
        ivf_build_s, ivf_host_runs = float("inf"), []
        for _ in range(2):
            ivf = IVFIndex(ivf_cfg)
            t0 = time.perf_counter()
            ivf.build(x)
            jax.block_until_ready(ivf.state)
            dt = time.perf_counter() - t0
            ivf_host_runs.append(round(n / dt, 1))
            ivf_build_s = min(ivf_build_s, dt)
        # device-resident corpus build. Warm first: the device-split
        # programs are distinct from the host build's
        xd = jax.device_put(x)
        jax.block_until_ready(xd)
        warm = IVFIndex(ivf_cfg)
        warm.build(xd)
        jax.block_until_ready(warm.state)
        del warm
        ivf_build_dev_s, ivf_dev_runs = float("inf"), []
        for _ in range(2):
            ivf_dev = IVFIndex(ivf_cfg)
            t0 = time.perf_counter()
            ivf_dev.build(xd)
            jax.block_until_ready(ivf_dev.state)
            dt = time.perf_counter() - t0
            ivf_dev_runs.append(round(n / dt, 1))
            ivf_build_dev_s = min(ivf_build_dev_s, dt)
        del ivf_dev, xd
        best_ivf = None
        for npb in (2, 4, 8):
            ids = []
            for lo in range(0, nq, batch):
                ids.append(np.asarray(ivf.search(q[lo:lo + batch], k, nprobe=npb)[1]))
            r = recall_at_k(np.concatenate(ids), gt, k)
            log(f"ivf nprobe={npb} recall={r:.4f}")
            if r >= TARGET_RECALL:
                best_ivf = (npb, r)
                break
        if best_ivf is None:
            best_ivf = (8, r)
        npb, ivf_recall = best_ivf
        ivf_qps, ivf_qps_runs = timed_qps(
            lambda qq: ivf.search(qq, k, nprobe=npb), q, batch)
        log(f"ivf: recall={ivf_recall:.4f} qps={ivf_qps:,.0f} "
            f"build={n/ivf_build_dev_s:,.0f} pts/s device-resident "
            f"(host-corpus {n/ivf_build_s:,.0f}) (nprobe={npb})")
        results["ivf"] = dict(recall=ivf_recall, qps=ivf_qps,
                              qps_runs=ivf_qps_runs,
                              build_pps=n / ivf_build_dev_s,
                              build_pps_hostcorpus=n / ivf_build_s, nprobe=npb,
                              build_runs_pps=ivf_dev_runs,
                              build_runs_pps_hostcorpus=ivf_host_runs)
        del ivf
    except Exception as e:  # keep the other sections running; exit nonzero
        fail("ivf", e)
    emit(results)

    # ---- cagra (100k protocol) ----------------------------------------------
    try:
        from zvdb_tpu import CagraConfig, CagraIndex

        def cagra_factory():
            return CagraIndex(CagraConfig(dim=d, degree=32, metric=metric))

        warm = cagra_factory()
        warm.build(x)                      # pays the one-off compiles
        jax.block_until_ready(warm.state)
        del warm
        cagra_build_s, cagra_host_runs = float("inf"), []
        for _ in range(2):
            cagra = cagra_factory()
            t0 = time.perf_counter()
            cagra.build(x)
            jax.block_until_ready(cagra.state)
            dt = time.perf_counter() - t0
            cagra_host_runs.append(round(n / dt, 1))
            cagra_build_s = min(cagra_build_s, dt)
        # device-resident corpus build
        xd = jax.device_put(x)
        jax.block_until_ready(xd)
        cagra_build_dev_s, cagra_dev_runs = float("inf"), []
        for _ in range(2):
            cdev = cagra_factory()
            t0 = time.perf_counter()
            cdev.build(xd)
            jax.block_until_ready(cdev.state)
            dt = time.perf_counter() - t0
            cagra_dev_runs.append(round(n / dt, 1))
            cagra_build_dev_s = min(cagra_build_dev_s, dt)
        del cdev, xd
        cagra_ef, cagra_recall = None, 0.0
        for ef in (12, 16, 24, 32, 48, 64, 96):
            ids = np.asarray(cagra.search(q[:2048], k, ef_search=ef)[1])
            r = recall_at_k(ids, gt[:2048], k)
            log(f"cagra ef={ef} recall={r:.4f}")
            if r >= TARGET_RECALL:
                cagra_ef, cagra_recall = ef, r
                break
        if cagra_ef is None:
            cagra_ef, cagra_recall = 128, r
        cagra_qps, cagra_qps_runs = timed_qps(
            lambda qq: cagra.search(qq, k, ef_search=cagra_ef), q, 5000, reps=3
        )
        log(f"cagra: recall={cagra_recall:.4f} qps={cagra_qps:,.0f} "
            f"build={n/cagra_build_dev_s:,.0f} pts/s device-resident "
            f"(host-corpus {n/cagra_build_s:,.0f}) (ef={cagra_ef})")
        results["cagra"] = dict(recall=cagra_recall, qps=cagra_qps,
                                qps_runs=cagra_qps_runs,
                                build_pps=n / cagra_build_dev_s,
                                build_pps_hostcorpus=n / cagra_build_s,
                                ef=cagra_ef, build_runs_pps=cagra_dev_runs,
                                build_runs_pps_hostcorpus=cagra_host_runs)
        del cagra
    except Exception as e:
        fail("cagra", e)
    emit(results)

    # ---- hnsw (oneshot bulk build, 100k protocol) ---------------------------
    try:
        def hnsw_factory():
            return HNSW(HNSWConfig(dim=d, m=16, ef_construction=100,
                                   metric=metric, build_batch=8192))

        warm = hnsw_factory()
        warm.build(x)                      # pays the one-off compiles
        jax.block_until_ready(warm.state)
        del warm
        hnsw_build_s, hnsw_host_runs = float("inf"), []
        for _ in range(2):
            hnsw = hnsw_factory()
            t0 = time.perf_counter()
            hnsw.build(x)
            jax.block_until_ready(hnsw.state)
            dt = time.perf_counter() - t0
            hnsw_host_runs.append(round(n / dt, 1))
            hnsw_build_s = min(hnsw_build_s, dt)
        # device-resident corpus build (oneshot path keeps device arrays
        # resident; the host number above includes the upload)
        xd = jax.device_put(x)
        jax.block_until_ready(xd)
        hnsw_build_dev_s, hnsw_dev_runs = float("inf"), []
        for _ in range(2):
            hdev = hnsw_factory()
            t0 = time.perf_counter()
            hdev.build(xd)
            jax.block_until_ready(hdev.state)
            dt = time.perf_counter() - t0
            hnsw_dev_runs.append(round(n / dt, 1))
            hnsw_build_dev_s = min(hnsw_build_dev_s, dt)
        del hdev, xd
        hnsw_ef = None
        hnsw_recall = 0.0
        for ef in (16, 24, 32, 48, 64, 96):
            ids = np.asarray(hnsw.search(q[:2048], k, ef_search=ef)[1])
            r = recall_at_k(ids, gt[:2048], k)
            log(f"hnsw ef={ef} recall={r:.4f}")
            if r >= TARGET_RECALL:
                hnsw_ef, hnsw_recall = ef, r
                break
        if hnsw_ef is None:
            hnsw_ef = 128
            hnsw_recall = r
        hnsw_qps, hnsw_qps_runs = timed_qps(
            lambda qq: hnsw.search(qq, k, ef_search=hnsw_ef), q, 5000, reps=2
        )
        log(f"hnsw: recall={hnsw_recall:.4f} qps={hnsw_qps:,.0f} "
            f"build={n/hnsw_build_dev_s:,.0f} pts/s device-resident "
            f"(host-corpus {n/hnsw_build_s:,.0f}) (ef={hnsw_ef})")
        results["hnsw"] = dict(recall=hnsw_recall, qps=hnsw_qps,
                               qps_runs=hnsw_qps_runs,
                               build_pps=n / hnsw_build_dev_s,
                               build_pps_hostcorpus=n / hnsw_build_s,
                               ef=hnsw_ef, build_runs_pps=hnsw_dev_runs,
                               build_runs_pps_hostcorpus=hnsw_host_runs)
        del hnsw
    except Exception as e:
        fail("hnsw", e)
    emit(results)

    # ---- flat at 1M (SIFT1M-scale config) -----------------------------------
    if x1 is not None:
        try:
            # two-pass: bf16 scan + exact f32 rerank
            fl1_cfg = FlatConfig(dim=d, metric=metric, rerank=4,
                                 recall_target=0.97, tile_n=500_000)
            b1, fl1_runs = float("inf"), []
            for _ in range(2):
                fl1 = FlatIndex(fl1_cfg, capacity=n1)
                t0 = time.perf_counter()
                fl1.add(x1)
                jax.block_until_ready(fl1.state)
                dt = time.perf_counter() - t0
                fl1_runs.append(round(n1 / dt, 1))
                b1 = min(b1, dt)
            ids1 = np.concatenate([
                np.asarray(fl1.search(q1[lo:lo + 2048], k, approx=True)[1])
                for lo in range(0, nq, 2048)
            ])
            r1 = recall_at_k(ids1, gt1, k)
            qps1, qps1_runs = timed_qps(
                lambda qq: fl1.search(qq, k, approx=True), q1, 2048)
            log(f"flat 1M: recall={r1:.4f} qps={qps1:,.0f} build={n1/b1:,.0f} pts/s")
            results["flat_1m"] = dict(recall=r1, qps=qps1,
                                      qps_runs=qps1_runs, build_pps=n1 / b1,
                                      build_runs_pps=fl1_runs)
            del fl1

            # fused bf16 scan + bin fold (ops/flat_scan.py) + exact rerank
            flp = FlatIndex(
                FlatConfig(dim=d, metric=metric, rerank=4, scan="pallas"),
                capacity=n1,
            )
            flp.add(x1)
            jax.block_until_ready(flp.state)
            idsp = np.concatenate([
                np.asarray(flp.search(q1[lo:lo + 2048], k, approx=True)[1])
                for lo in range(0, nq, 2048)
            ])
            rp = recall_at_k(idsp, gt1, k)
            qpsp, qpsp_runs = timed_qps(
                lambda qq: flp.search(qq, k, approx=True), q1, 2048)
            log(f"flat 1M pallas: recall={rp:.4f} qps={qpsp:,.0f}")
            results["flat_1m_pallas"] = dict(recall=rp, qps=qpsp,
                                             qps_runs=qpsp_runs)
            del flp
        except Exception as e:
            fail("flat 1M", e)
        emit(results)

    # ---- optional >=30M single-card PQ scale row (ZVDB_BENCH_SCALE=rows) ---
    # Off by default: it would multiply the run's wall time.
    scale_n = int(os.environ.get("ZVDB_BENCH_SCALE", "0"))
    if scale_n:
        # ZVDB_BENCH_SCALE_ENGINE: "pq" (flat scan, linear), "ivfpq" (the
        # sublinear probed tier), or a comma list to run both on the same
        # protocol.
        for eng in os.environ.get("ZVDB_BENCH_SCALE_ENGINE",
                                  "pq").split(","):
            try:
                tag, row = run_pq_scale(scale_n, k, engine=eng.strip())
                results[tag] = row
            except Exception as e:
                fail(f"{eng} scale", e)
            emit(results)
    if FAILED:
        log(f"failed sections: {FAILED}")
        sys.exit(1)


if __name__ == "__main__":
    main()
