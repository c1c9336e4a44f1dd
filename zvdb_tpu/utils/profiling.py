"""Profiling & tracing hooks (SURVEY.md §5: the reference has only wall-clock
timers in its bench runners; this provides device traces + phase timing).

Usage:
    from zvdb_tpu.utils.profiling import trace, Phase

    with trace(trace_dir):          # XLA device trace (TensorBoard)
        idx.search(q, 10)

    with Phase("build") as p:               # wall-clock phase timing
        idx.build(x)
    print(p.elapsed_s)

    timings = PhaseRecorder()
    with timings.phase("search"):
        ...
    print(timings.report())
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context; view in TensorBoard / xprof."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Phase:
    """Wall-clock phase timer that blocks on device work at exit."""

    def __init__(self, name: str, sync: bool = True):
        self.name = name
        self.sync = sync
        self.elapsed_s: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync:
            try:
                (jax.device_put(0.0) + 0).block_until_ready()
            except Exception:
                pass
        self.elapsed_s = time.perf_counter() - self._t0
        return False


class PhaseRecorder:
    """Accumulates named phase timings; emits a structured report."""

    def __init__(self):
        self.records: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = True):
        p = Phase(name, sync=sync)
        with p:
            yield p
        self.records.setdefault(name, []).append(p.elapsed_s)

    def report(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, ts in self.records.items():
            out[name] = {
                "count": len(ts),
                "total_s": sum(ts),
                "mean_s": sum(ts) / len(ts),
                "min_s": min(ts),
                "max_s": max(ts),
            }
        return out


def live_buffer_bytes() -> int:
    """Total bytes of live device buffers (the buffer-donation / leak check —
    the accelerator analog of the reference's allocator leak tests,
    SURVEY.md §4)."""
    total = 0
    for d in jax.live_arrays():
        total += d.nbytes
    return total
