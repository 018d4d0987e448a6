"""Tracing / throughput observability.

The reference has no timers or perf counters anywhere (SURVEY.md §5);
this module supplies the JAX equivalents: `jax.profiler` trace
capture around any run section, and a pair-site throughput meter for the
headline updates/sec metric (BASELINE.json).
"""

from __future__ import annotations

import contextlib
import sys
import time
from dataclasses import dataclass, field
from typing import Optional


@contextlib.contextmanager
def trace(trace_dir: Optional[str]):
    """Capture a jax.profiler trace (TensorBoard format) around the
    enclosed section; no-op when trace_dir is falsy."""
    if not trace_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(trace_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclass
class Throughput:
    """Pair-site updates/sec meter.

    One `update`/`add_updates` per completed replicate, counting the
    pair-site distance updates the reference hot loop would execute
    (/root/reference/ngsDist.cpp:333-353): bootstrap replicates run over
    the block-truncated site count and pairwise deletion skips missing
    sites entirely, so the caller passes the actual per-replicate
    valid-update total, not n_pairs * n_sites.
    """

    n_pairs: int
    t0: float = field(default_factory=time.perf_counter)
    updates: float = 0.0
    replicates: int = 0

    def update(self, n_sites: int) -> None:
        self.add_updates(float(self.n_pairs) * float(n_sites))

    def add_updates(self, updates: float) -> None:
        self.updates += float(updates)
        self.replicates += 1

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    @property
    def rate(self) -> float:
        e = self.elapsed
        return self.updates / e if e > 0 else 0.0

    def report(self, fh=None) -> None:
        print(
            f"==> Throughput: {self.updates:.3e} pair-site updates over "
            f"{self.replicates} matrices in {self.elapsed:.2f}s "
            f"({self.rate:.3e} updates/s)",
            file=fh if fh is not None else sys.stderr,
        )
