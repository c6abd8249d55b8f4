"""Tracing & profiling utilities.

The reference instruments its hot path with chrono cout macros gated by
``debug_print`` (reference: localization_functions.hpp:70-76, used at
pcm_matching.cpp:213-323 and registration.cpp:307-403). The JAX equivalents:
host-side wall timers that force device completion, stage annotations that
show up in ``jax.profiler`` traces, and a tiny aggregator that prints a
per-stage dashboard.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import jax


class StageTimers:
    """Accumulates wall-clock per named stage (host-side, device-synced)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Time a block; pass the block's output pytree via ``sync`` (or call
        .sync(out) inside) to include device execution, not just dispatch."""
        if not self.enabled:
            yield self
            return
        t0 = time.perf_counter()
        with jax.profiler.TraceAnnotation(name):
            yield self
        if sync is not None:
            jax.block_until_ready(sync)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def sync(self, out):
        jax.block_until_ready(out)
        return out

    def report(self) -> str:
        """Per-stage dashboard (the STOP_TIMER printout, aggregated)."""
        lines = ["stage                      total_ms    calls   ms/call"]
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            t, c = self.totals[name] * 1e3, self.counts[name]
            lines.append(f"{name:<26s} {t:9.2f} {c:8d} {t / max(c, 1):9.3f}")
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Capture a jax.profiler device trace around a block (view in
    TensorBoard / Perfetto). No-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
