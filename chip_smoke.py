#!/usr/bin/env python
"""Smoke run of the main path on the GPU: build, search and serve at 1M x 128d.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --multi    # four cards: the sharded path only

Phases (each prints one result line with its seconds; any failure exits 1):

  device   jax.devices() must be GPUs (no CPU fallback); prints the card's
           name and power limit as nvidia-smi reports them.
  oracle   exact ground truth on the card (FlatIndex, precision "highest")
           for the 100k "sift1m" stand-in and the 1M clustered corpus,
           checked against the host float64 BLAS oracle on 1,000 queries.
  engines  every engine at its bench.py config, recall@10 >= 0.95 against
           that ground truth, plus what precision "high" lowered to.
  serve    the 1M CagraIndex behind SearchServer: 8 client threads, 256
           single-query requests, each answer equal to index.search.
  kernels  each Triton-route kernel against its plain jnp reference at real
           widths, both timed: the flat scan + bin fold at 1M x 128d,
           B = 2048 (and FlatIndex's fused path against its XLA scan), and
           the grouped ADC scan at the IVF-PQ bench config (1M, B = 2048,
           nprobe 8), inside the search step and alone.

--multi builds a 4-card mesh over the 1M corpus and checks ShardedFlat
against single-card exact search, and ShardedHNSW and ShardedIVFPQ against
their single-card engines; each sharded state must span 4 devices.

Data comes from --seed. The last stdout line is one JSON object naming the
device; it is printed only when every phase passed. One process holds the
card: nothing here starts a second JAX process.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import threading
import time

import numpy as np

K = 10
N_QUERIES = 10_000
N_ORACLE = 1_000
TARGET = 0.95


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseFailed(Exception):
    pass


def phase(name: str, fn, *args):
    """Run one phase; print its result line and seconds."""
    t0 = time.perf_counter()
    try:
        out, summary = fn(*args)
    except Exception as e:  # noqa: BLE001 - every failure ends the run
        log(f"[{name}] FAIL after {time.perf_counter() - t0:.1f}s: {e!r}")
        raise PhaseFailed(name) from e
    log(f"[{name}] ok {time.perf_counter() - t0:.1f}s {summary}")
    return out


def recall(ids, gt) -> float:
    from zvdb_tpu.bench.harness import recall_at_k

    return recall_at_k(np.asarray(ids), np.asarray(gt), K)


def batched(fn, q, batch: int):
    return np.concatenate([np.asarray(fn(q[lo:lo + batch])[1])
                           for lo in range(0, q.shape[0], batch)])


# ---------------------------------------------------------------- data


def make_data(seed: int):
    """The 100k "sift1m" stand-in with perturbed-corpus queries and the 1M
    clustered corpus with its own query stream (bench.py's generators)."""
    from zvdb_tpu.io.datasets import load_dataset, synthetic_clustered

    x, _, _, _ = load_dataset("sift1m", max_rows=100_000, seed=seed)
    rng = np.random.default_rng(9 + seed)
    q = (x[rng.integers(0, x.shape[0], N_QUERIES)]
         + 0.05 * rng.standard_normal((N_QUERIES, x.shape[1]))
         ).astype(np.float32)
    n1 = 1_000_000
    x1 = synthetic_clustered(n1, 128, n_clusters=10_000, seed=seed)
    qrng = np.random.default_rng(777 + seed)
    q1 = (x1[qrng.integers(0, n1, N_QUERIES)]
          + 0.05 * qrng.standard_normal((N_QUERIES, 128))).astype(np.float32)
    return x, q, x1, q1


# ---------------------------------------------------------------- phases


def device_phase():
    import jax

    devs = jax.devices()
    if not devs or any(d.platform != "gpu" for d in devs):
        raise RuntimeError(f"no GPU: jax.devices() = {devs}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(smi)
    return devs, f"{len(devs)} x {devs[0].device_kind}"


def exact_gt(x, q):
    from zvdb_tpu import FlatConfig, FlatIndex

    idx = FlatIndex(FlatConfig(dim=x.shape[1], precision="highest",
                               tile_n=262144), capacity=x.shape[0])
    idx.add(x)
    return batched(lambda qq: idx.search(qq, K), q, 2048)


def check_against_host(x, q, gt_dev):
    """Id agreement of the card's exact top-k with the host float64 oracle.

    Tolerance: f32 scores are ||x||^2 - 2 q.x with terms as large as
    ||q||^2 + ||x||^2, accumulated over D products; 1e-5 of that magnitude
    is ~100 ulps. A position whose two ids' float64 distances differ by
    less than it is a tie, not a disagreement."""
    from zvdb_tpu.bench.harness import ground_truth_host

    qs = q[:N_ORACLE].astype(np.float64)
    _, gt_host = ground_truth_host(x, qs, K, dtype=np.float64)
    dev = gt_dev[:N_ORACLE]
    xd = x.astype(np.float64)
    same = dev == gt_host
    ties = 0
    for r, c in zip(*np.nonzero(~same)):
        d_dev = ((xd[dev[r, c]] - qs[r]) ** 2).sum()
        d_host = ((xd[gt_host[r, c]] - qs[r]) ** 2).sum()
        tol = 1e-5 * ((qs[r] ** 2).sum() + (xd[gt_host[r, c]] ** 2).sum())
        ties += abs(d_dev - d_host) < tol
    agree = (same.sum() + ties) / same.size
    if agree < 0.999:
        raise AssertionError(f"id agreement {agree:.5f} < 0.999")
    return agree, same.mean()


def oracle_phase(x, q, x1, q1):
    gt = exact_gt(x, q)
    gt1 = exact_gt(x1, q1)
    a, raw = check_against_host(x, q, gt)
    a1, raw1 = check_against_host(x1, q1, gt1)
    return (gt, gt1), (f"100k agreement {a:.5f} (exact ids {raw:.5f}); "
                       f"1M agreement {a1:.5f} (exact ids {raw1:.5f}); "
                       "tie tolerance 1e-5 * (|q|^2 + |x|^2)")


def high_precision_lowering() -> str:
    """What a precision="high" f32 scoring matmul becomes in the optimized
    HLO on this card: the dot's algorithm, or the library call it becomes."""
    import jax
    import jax.numpy as jnp

    from zvdb_tpu.ops import distance as D

    q = jnp.ones((2048, 128), jnp.float32)
    x = jnp.ones((65536, 128), jnp.float32)
    n = jnp.ones((65536,), jnp.float32)
    f = jax.jit(lambda q, x, n: D.pairwise_scores(
        q, x, n, "l2", precision=D.matmul_precision("high")))
    txt = f.lower(q, x, n).compile().as_text()
    found = set(re.findall(r"algorithm=(\w+)", txt))
    found |= set(re.findall(r'"algorithm":"(\w+)"', txt))
    found |= set(re.findall(r'custom_call_target="([^"]+)"', txt))
    found |= {f"operand_precision={p}" for p in
              re.findall(r'"operand_precision":\[([^\]]*)\]', txt)}
    return ", ".join(sorted(found)) or "plain dot"


def engines_phase(x, q, x1, q1, gt, gt1):
    """Build and search each engine at its bench.py config."""
    import jax

    from zvdb_tpu import (HNSW, CagraConfig, CagraIndex, FlatConfig,
                          FlatIndex, HNSWConfig, IVFConfig, IVFIndex,
                          IVFPQConfig, IVFPQIndex, PQConfig, PQFlatIndex)

    d = x.shape[1]
    rows, failed, keep = [], [], {}

    def check(name, ids, g, extra=""):
        r = recall(ids, g)
        rows.append(f"{name} {r:.4f}{extra}")
        log(f"  {name}: recall@10 {r:.4f}{extra}")
        if r < TARGET:
            failed.append(name)
        return r

    def first_ok(search, options, g):
        """bench.py's knob search: the first option reaching the target
        on the first 2048 queries, else the last."""
        for opt in options:
            if recall(np.asarray(search(q[:2048], opt)[1]), g[:2048]) \
                    >= TARGET:
                return opt
        return options[-1]

    log(f"  precision 'high' lowers to: {high_precision_lowering()}")
    xd1 = jax.device_put(x1)

    flat = FlatIndex(FlatConfig(dim=d, precision="high", recall_target=0.97,
                                tile_n=131072), capacity=x.shape[0])
    flat.add(x)
    check("flat_100k", batched(lambda qq: flat.search(qq, K, approx=True),
                               q, N_QUERIES), gt)
    del flat

    fl1 = FlatIndex(FlatConfig(dim=d, rerank=4, recall_target=0.97,
                               tile_n=500_000), capacity=x1.shape[0])
    fl1.add(x1)
    check("flat_1m", batched(lambda qq: fl1.search(qq, K, approx=True),
                             q1, 2048), gt1)
    del fl1

    ivf = IVFIndex(IVFConfig(dim=d, n_clusters=1024, nprobe=8,
                             kmeans_iters=4, kmeans_sample=65536))
    ivf.build(x)
    npb = first_ok(lambda qq, o: ivf.search(qq, K, nprobe=o), (2, 4, 8), gt)
    check("ivf_100k", batched(lambda qq: ivf.search(qq, K, nprobe=npb),
                              q, N_QUERIES), gt, f" (nprobe {npb})")
    del ivf

    hnsw = HNSW(HNSWConfig(dim=d, m=16, ef_construction=100,
                           build_batch=8192))
    hnsw.build(x)
    ef = first_ok(lambda qq, o: hnsw.search(qq, K, ef_search=o),
                  (16, 24, 32, 48, 64, 96, 128), gt)
    check("hnsw_100k", batched(lambda qq: hnsw.search(qq, K, ef_search=ef),
                               q, 5000), gt, f" (ef {ef})")
    del hnsw

    cagra = CagraIndex(CagraConfig(dim=d, degree=32,
                                   n_anchors=min(262144, x1.shape[0] // 4),
                                   search_degree=24, max_iters=4,
                                   ef_search=12))
    cagra.build(xd1)
    check("cagra_1m", batched(lambda qq: cagra.search(qq, K, ef_search=12),
                              q1, 5000), gt1, " (ef 12)")
    keep["cagra"] = cagra

    pq = PQFlatIndex(PQConfig(dim=d))
    pq.build(xd1)
    check("pq_1m", batched(lambda qq: pq.search(qq, K), q1, 2048), gt1)
    del pq

    ipq = IVFPQIndex(IVFPQConfig(dim=d))
    ipq.build(xd1)
    check("ivfpq_1m", batched(
        lambda qq: ipq.search(qq, K, nprobe=8, rerank=12), q1, 2048), gt1,
        " (nprobe 8, rerank 12)")
    keep["ivfpq"] = ipq
    del xd1

    if failed:
        raise AssertionError(f"recall@10 under {TARGET}: {failed}")
    return keep, "; ".join(rows)


def serve_phase(index, q1):
    from zvdb_tpu import SearchServer

    qs = q1[:256]
    want = np.stack([np.asarray(index.search(qq[None], K)[1])[0]
                     for qq in qs])
    got = [None] * len(qs)
    errors = []

    def client(tid):
        try:
            for i in range(tid, len(qs), 8):
                got[i] = np.asarray(server.search(qs[i], timeout=600)[1])
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    with SearchServer(index, K, max_batch=64, max_wait_ms=2.0) as server:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    got = np.stack(got)
    bad = int((got != want).any(axis=1).sum())
    if bad:
        raise AssertionError(f"{bad} of {len(qs)} answers differ from "
                             "index.search")
    return None, f"{len(qs)} requests from 8 threads match index.search"


def time_ms(fn, reps: int = 10) -> float:
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    outs = [fn() for _ in range(reps)]
    jax.block_until_ready(outs)
    return (time.perf_counter() - t0) / reps * 1e3


def kernels_phase(x1, q1, gt1, ipq):
    """Each kernel vs its plain jnp reference at real widths.

    Flat: both sides take the same inputs at precision "default": bf16
    operands (exact products in f32) with f32 accumulation, so the two
    differ only in summation order. Tolerance 1e-5 * (|q|^2 + max |x|^2)
    per query; a bin's id is checked by its reference score (ties aside).
    Grouped ADC ("int8" table): integer sums exact in f32 on both sides,
    so bins agree to f32 rounding of the final rescale (tolerance 1e-5 *
    max |score|) and positions agree exactly unless two rows tie."""
    import jax
    import jax.numpy as jnp

    from zvdb_tpu import FlatConfig, FlatIndex
    from zvdb_tpu.ops import distance as D
    from zvdb_tpu.ops.flat_scan import flat_scan_bins, \
        flat_scan_bins_reference, interpret_mode

    cfg = FlatConfig(dim=128)
    kw = dict(l_bins=cfg.l_bins, seg_rows=cfg.pallas_chunk)
    fused = dict(bq=cfg.pallas_bq, interpret=interpret_mode())
    xd = jax.device_put(x1)
    nd = D.sq_norms(xd)
    qd = jax.device_put(q1[:2048])
    ks, ki = flat_scan_bins(qd, xd, nd, **fused, **kw)
    rs, ri = flat_scan_bins_reference(qd, xd, nd, **kw)
    ks, ki, rs, ri = map(np.asarray, (ks, ki, rs, ri))
    tol = 1e-5 * ((q1[:2048] ** 2).sum(1) + float(np.max(np.asarray(nd))))
    live = np.isfinite(rs)
    if not np.array_equal(live, np.isfinite(ks)):
        raise AssertionError("kernel and reference disagree on empty bins")
    err = np.abs(ks - rs)
    if not (err[live] <= np.broadcast_to(tol[:, None], err.shape)[live]).all():
        raise AssertionError(f"bin scores differ by up to {err[live].max()}")
    # the kernel's id must score as its bin's minimum under the reference
    xq = q1[:2048]
    rows = np.nonzero(ki != ri)
    for r, c in zip(rows[0][:2000], rows[1][:2000]):
        sc = float(np.asarray(nd)[ki[r, c]]) - 2.0 * float(
            xq[r] @ x1[ki[r, c]])
        if abs(sc - rs[r, c]) > tol[r]:
            raise AssertionError(f"bin ({r}, {c}) holds a non-minimal id")
    t_kernel = time_ms(lambda: flat_scan_bins(qd, xd, nd, **fused, **kw))
    t_ref = time_ms(lambda: flat_scan_bins_reference(qd, xd, nd, **kw))
    del xd, nd

    out = []
    for scan in ("xla", "pallas"):
        idx = FlatIndex(FlatConfig(dim=128, rerank=4, recall_target=0.97,
                                   tile_n=500_000, scan=scan),
                        capacity=x1.shape[0])
        idx.add(x1)
        r = recall(batched(lambda qq: idx.search(qq, K, approx=True),
                           q1, 2048), gt1)
        t = time_ms(lambda: idx.search(qd, K, approx=True), reps=5)
        out.append(f"flat_1m scan={scan} {t:.2f} ms/2048 queries "
                   f"recall {r:.4f}")
        del idx
    out.append(f"flat bins: kernel {t_kernel:.2f} ms vs jnp reference "
               f"{t_ref:.2f} ms (ids equal {np.mean(ki == ri):.5f})")
    out.append(grouped_scan_check(ipq, qd, q1, gt1))
    return None, "; ".join(out)


def grouped_scan_check(ipq, qd, q1, gt1) -> str:
    import jax

    from zvdb_tpu.index import ivfpq as IV
    from zvdb_tpu.ops import distance as D
    from zvdb_tpu.ops.flat_scan import interpret_mode
    from zvdb_tpu.ops.pq_grouped import pq_grouped_scan_bins, \
        pq_grouped_scan_bins_fused

    st, cfg = ipq.state, ipq.cfg
    lut, qslot, _ = jax.jit(IV.probe_slots, static_argnums=(2, 3, 4))(
        st, D.preprocess_queries(qd, cfg.metric), 8, cfg.metric,
        cfg.group_slack)
    kw = dict(l_bins=cfg.l_bins, chunk=cfg.chunk, metric=cfg.metric,
              precision=cfg.scan_precision, per_bin=cfg.per_bin)
    args = (lut, qslot, st.codes_blocks, st.norms_blocks)
    interp = interpret_mode()
    ks, kp = map(np.asarray, pq_grouped_scan_bins_fused(
        *args, interpret=interp, **kw))
    rs, rp = map(np.asarray, pq_grouped_scan_bins(*args, **kw))
    live = np.isfinite(rs)
    if not np.array_equal(live, np.isfinite(ks)):
        raise AssertionError("grouped scan: empty bins differ")
    tol = 1e-5 * np.abs(rs[live]).max()
    if np.abs(ks[live] - rs[live]).max() > tol:
        raise AssertionError("grouped scan: bin scores differ")
    t_kernel = time_ms(lambda: pq_grouped_scan_bins_fused(
        *args, interpret=interp, **kw))
    t_ref = time_ms(lambda: pq_grouped_scan_bins(*args, **kw))
    search = lambda: ipq.search(qd, K, nprobe=8, rerank=12)
    r_k, t_k = recall(search()[1], gt1[:2048]), time_ms(search)
    # the same search step with the plain scan in the kernel's place
    IV.pq_grouped_scan_bins_fused = (
        lambda *a, interpret=False, **k: pq_grouped_scan_bins(*a, **k))
    try:
        jax.clear_caches()
        r_x, t_x = recall(search()[1], gt1[:2048]), time_ms(search)
    finally:
        IV.pq_grouped_scan_bins_fused = pq_grouped_scan_bins_fused
        jax.clear_caches()
    return (f"grouped ADC scan: kernel {t_kernel:.2f} ms vs jnp reference "
            f"{t_ref:.2f} ms (positions equal {np.mean(kp == rp):.5f}); "
            f"ivfpq_1m search step {t_k:.2f} ms (recall {r_k:.4f}) vs "
            f"{t_x:.2f} ms with the plain scan (recall {r_x:.4f}), "
            f"qslot {tuple(qslot.shape)}")


# ---------------------------------------------------------------- 4 cards


def multi_phase(x1, q1, gt1):
    """The sharded path on a 4-card mesh against single-card engines."""
    import jax

    from zvdb_tpu import (HNSW, FlatConfig, HNSWConfig, IVFPQConfig,
                          IVFPQIndex, ShardedFlat, ShardedHNSW, ShardedIVFPQ,
                          make_mesh)

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--multi needs 4 GPUs, have {len(jax.devices())}")
    mesh = make_mesh(n_shards=4, devices=jax.devices()[:4])
    d = x1.shape[1]
    rows = []

    def spans_four(state, name):
        devs = {s.device for leaf in jax.tree.leaves(state)
                if hasattr(leaf, "addressable_shards")
                for s in leaf.addressable_shards}
        if len(devs) != 4:
            raise AssertionError(f"{name} state spans {len(devs)} devices")

    sf = ShardedFlat(FlatConfig(dim=d, precision="highest"), mesh=mesh)
    sf.build(x1)
    spans_four(sf.state, "ShardedFlat")
    ids = batched(lambda qq: sf.search(qq, K, approx=False), q1, 2048)
    diff = ids != gt1
    if diff.any():
        # ties aside: a differing id must be as close as the single-card one
        xd = x1.astype(np.float64)
        for r, c in zip(*np.nonzero(diff)):
            qq = q1[r].astype(np.float64)
            a = ((xd[ids[r, c]] - qq) ** 2).sum()
            b = ((xd[gt1[r, c]] - qq) ** 2).sum()
            if abs(a - b) >= 1e-5 * ((qq ** 2).sum() + (xd[gt1[r, c]] ** 2)
                                     .sum()):
                raise AssertionError(f"ShardedFlat differs at query {r}")
    rows.append(f"ShardedFlat == FlatIndex exact ({int(diff.sum())} ties)")
    del sf

    def compare(name, single, sharded):
        r1, rs = recall(single, gt1), recall(sharded, gt1)
        rows.append(f"{name} {rs:.4f} vs single {r1:.4f}")
        if rs < TARGET or rs < r1 - 0.01:
            raise AssertionError(f"{name} recall {rs:.4f} (single {r1:.4f})")

    hcfg = HNSWConfig(dim=d, m=16, ef_construction=100, build_batch=8192)
    h1 = HNSW(hcfg)
    h1.build(x1)
    single = batched(lambda qq: h1.search(qq, K, ef_search=64), q1, 5000)
    del h1
    sh = ShardedHNSW(hcfg, mesh=mesh)
    sh.build(x1)
    spans_four(sh.state, "ShardedHNSW")
    compare("ShardedHNSW (ef 64)", single,
            batched(lambda qq: sh.search(qq, K, ef_search=64), q1, 5000))
    del sh

    pcfg = IVFPQConfig(dim=d)
    p1 = IVFPQIndex(pcfg)
    p1.build(x1)
    single = batched(lambda qq: p1.search(qq, K, nprobe=8, rerank=12),
                     q1, 2048)
    del p1
    sp = ShardedIVFPQ(pcfg, mesh=mesh)
    sp.build(x1)
    spans_four(sp.state, "ShardedIVFPQ")
    compare("ShardedIVFPQ (nprobe 8, rerank 12)", single, batched(
        lambda qq: sp.search(qq, K, nprobe=8, rerank=12), q1, 2048))
    return None, "; ".join(rows)


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multi", action="store_true",
                    help="run the 4-card sharded path (and only it)")
    args = ap.parse_args(argv)

    import jax

    from zvdb_tpu.utils.cache import setup_compile_cache

    setup_compile_cache()
    try:
        devs = phase("device", device_phase)
        x, q, x1, q1 = phase("data", lambda: (make_data(args.seed),
                                              "100k + 1M corpora"))
        if args.multi:
            gt1 = phase("oracle", lambda: (exact_gt(x1, q1), "1M exact"))
            phase("multi", multi_phase, x1, q1, gt1)
        else:
            gt, gt1 = phase("oracle", oracle_phase, x, q, x1, q1)
            keep = phase("engines", engines_phase, x, q, x1, q1, gt, gt1)
            phase("serve", serve_phase, keep.pop("cagra"), q1)
            phase("kernels", kernels_phase, x1, q1, gt1, keep.pop("ivfpq"))
    except PhaseFailed:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
