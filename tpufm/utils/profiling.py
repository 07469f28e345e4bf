"""Profiling helpers — the translation of the reference's observability
(SURVEY.md section 5): wall-clock TIME: protocol -> timed_iterations
(tpufm.utils.timer); LIKWID MEM/TLB marker regions -> jax.profiler traces +
derived HBM-bandwidth estimates against speed-of-light.
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def trace(out_dir: str):
    """Capture a jax.profiler trace (view with TensorBoard / xprof).

    The tpufm analog of wrapping the Search region in LIKWID markers
    (reference common/searchQueries.c:87-93)."""
    jax.profiler.start_trace(out_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def search_stats(
    seconds_per_pass: float,
    num_reads: int,
    read_len: int,
    k: int,
    entry_bytes: int,
    hbm_bw: float,
) -> dict:
    """Derived metrics for one search pass: reads/s, k-step rounds/s, gather
    rate, achieved random-access bandwidth, and fraction of the HBM
    speed-of-light for this entry size (hbm_bw: the device's published
    peak, tpufm.bench.hbm_peak_bytes_per_s)."""
    rounds = read_len // k
    gathers = 2 * num_reads * rounds
    gathered_bytes = gathers * entry_bytes
    return {
        "reads_per_s": num_reads / seconds_per_pass,
        "rounds_per_s": num_reads * rounds / seconds_per_pass,
        "gathers_per_s": gathers / seconds_per_pass,
        "gathered_bytes_per_s": gathered_bytes / seconds_per_pass,
        "fraction_of_hbm_sol": gathered_bytes / seconds_per_pass / hbm_bw,
    }
