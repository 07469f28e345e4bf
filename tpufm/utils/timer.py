"""Wall-clock timing, the equivalent of the reference's sampleTime
(reference common/common.c:28-33) + 5-iteration TIME: protocol
(reference common/searchQueries.c:78-118)."""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field


class Timer:
    def __init__(self):
        self.start = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.start


@dataclass
class RunRecord:
    """Structured run record (replaces the reference's printf-only metrics)."""

    config: dict = field(default_factory=dict)
    metrics: dict = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps({"config": self.config, "metrics": self.metrics})


def timed_iterations(fn, iterations: int = 5) -> float:
    """Run fn() `iterations` times, return mean seconds per iteration.

    Mirrors the reference protocol: one wall-clock number, mean of 5 repeats
    (reference common/searchQueries.c:78-98, prints TIME: delta/iterations).
    """
    t0 = time.perf_counter()
    for _ in range(iterations):
        fn()
    return (time.perf_counter() - t0) / iterations


def timed_device_passes(fn, iterations: int = 5, warmup: int = 1):
    """Time `iterations` passes of fn(), each ending in block_until_ready.

    Returns (mean_seconds, min_seconds). fn must return a device value.
    The reference's TIME: protocol (mean of 5, common/searchQueries.c:78-118)
    maps to mean_seconds; min_seconds is the steady-state number.
    """
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn())
    times = []
    for _ in range(iterations):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return sum(times) / len(times), min(times)
