#!/usr/bin/env python
"""Benchmark entry point: prints ONE JSON line
{"metric": ..., "value": N, "unit": ..., "vs_baseline": N | null, ...}.

Runs the flagship configuration (k-step FM-index backward search, k/d/LUT
from recommend_config — k=3 d=192 lut12 — 10 Mbase reference, 1M reads x
120 bp) on the available device once. On a GPU a genome-scale row
(250 Mbase, device-built index) follows under detail.genome_scale.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    from tpufm.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import jax

    from tpufm.bench import run_bench, run_bench_genome
    from tpufm.config import device_bytes_limit, recommend_config

    refsize = int(os.environ.get("TPUFM_BENCH_REFSIZE", 10_000_000))
    query_len = int(os.environ.get("TPUFM_BENCH_LEN", 120))
    rec = recommend_config(
        refsize, query_len=query_len, bytes_limit=device_bytes_limit()
    )
    k = int(os.environ.get("TPUFM_BENCH_K", rec["k"]))
    if "TPUFM_BENCH_LUT" in os.environ:
        lut_m = int(os.environ["TPUFM_BENCH_LUT"])
    elif k == rec["k"]:
        lut_m = rec["lut_m"]
    else:
        # user-overridden k: largest m <= 12 compatible with k and the length
        lut_m = next(
            (
                m
                for m in range(12, 0, -1)
                if m % k == 0 and (query_len - m) % k == 0
            ),
            0,
        )
    record = run_bench(
        refsize=refsize,
        k=k,
        d=int(os.environ.get("TPUFM_BENCH_D", rec["d"])),
        num_queries=int(os.environ.get("TPUFM_BENCH_QUERIES", 1048576)),
        query_len=query_len,
        iterations=int(os.environ.get("TPUFM_BENCH_ITERS", 5)),
        engine=os.environ.get("TPUFM_BENCH_ENGINE", "xla"),
        lut_m=lut_m,
    )
    # Genome-scale second row (the regime the reference protocol actually
    # swept — slurm_genindexes.sh:42 builds 0.75-3 Gbase references).
    if (
        os.environ.get("TPUFM_BENCH_GENOME", "1") != "0"
        and jax.devices()[0].platform == "gpu"
    ):
        record["detail"]["genome_scale"] = run_bench_genome(
            refsize=int(
                os.environ.get("TPUFM_BENCH_GENOME_REFSIZE", 250_000_000)
            )
        )
    print(json.dumps(record))


if __name__ == "__main__":
    main()
