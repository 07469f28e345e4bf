"""Experiment sweep driver — the tpufm replacement for the reference's
SGE/SLURM script matrix (reference scripts/sge_searchcpu_bases.sh etc.,
SURVEY.md section 2 row 15).

Where the reference submitted one cluster job per (refsize, d, k, layout)
binary, tpufm runs the sweep in-process: each configuration is one jit
specialization, and every result is a structured JSON record.
"""

from __future__ import annotations

import itertools
import json
import time

import numpy as np


#: engines run_sweep can dispatch (unknown names raise — a typo'd engine
#: must never silently produce records labeled with a different engine).
SWEEP_ENGINES = ("xla", "xla-split", "xla-ac", "xla-paired")


def _make_engine(engine: str, index, lut_m: int):
    """Engine factory for sweep rows. Returns None for combinations that do
    not exist (the AC layout has no LUT path); raises on unknown names."""
    from tpufm.engine.xla import XLAEngine
    from tpufm.index.layouts import make_alt_counters

    if engine == "xla":
        return XLAEngine(index, lut_m=lut_m)
    if engine == "xla-split":
        return XLAEngine(index, layout="split", lut_m=lut_m)
    if engine == "xla-paired":
        return XLAEngine(index, layout="paired", lut_m=lut_m) if lut_m else None
    if engine == "xla-ac":
        return XLAEngine(make_alt_counters(index)) if lut_m == 0 else None
    raise ValueError(f"unknown engine {engine!r}; known: {SWEEP_ENGINES}")


def run_sweep(
    refsizes=(1_000_000,),
    ks=(1, 2),
    ds=(64,),
    engines=("xla",),
    lut_ms=(0,),
    num_queries: int = 65536,
    query_len: int = 120,
    iterations: int = 3,
    seed: int = 0,
    out_path: str | None = None,
    verify: bool = True,
):
    """Run the (refsize x k x d x engine x lut_m) matrix; returns a list of
    records and optionally appends them as JSON lines to out_path."""
    import jax
    import jax.numpy as jnp

    from tpufm.config import IndexConfig
    from tpufm.engine.oracle import search_oracle
    from tpufm.index.builder import build_index
    from tpufm.io.genreads import generate_reads

    for engine in engines:  # validate the whole matrix up front
        if engine not in SWEEP_ENGINES:
            raise ValueError(f"unknown engine {engine!r}; known: {SWEEP_ENGINES}")

    records = []
    rng = np.random.default_rng(seed)
    fh = open(out_path, "a") if out_path else None

    for refsize in refsizes:
        codes = rng.integers(0, 4, size=refsize, dtype=np.uint8)
        queries = generate_reads(codes, query_len, num_queries, seed=seed + 1)
        for k, d in itertools.product(ks, ds):
            if query_len % k:
                continue
            cfg = IndexConfig(k=k, d=d)
            t0 = time.perf_counter()
            # one build per (refsize, k, d): shared across engine variants
            index = build_index(codes, cfg)
            build_s = time.perf_counter() - t0

            qd = jax.device_put(jnp.asarray(queries, jnp.uint8))
            for engine, lut_m in itertools.product(engines, lut_ms):
                if lut_m and (lut_m % k or (query_len - lut_m) % k):
                    continue
                eng = _make_engine(engine, index, lut_m)
                if eng is None:
                    continue

                from tpufm.utils.timer import timed_device_passes

                dt, _ = timed_device_passes(
                    lambda: eng.search_device(qd), iterations=iterations
                )
                out = eng.search_device(qd)

                exact = None
                if verify:
                    # Uniform random sample (not the head): >=4K reads per
                    # row, the same sampling discipline as bench.py.
                    if engine == "xla-paired":
                        # repair lanes are only correct via engine.search
                        host = eng.search(queries)
                    else:
                        host = np.asarray(jax.device_get(out))
                    n_v = min(num_queries, 4096)
                    vidx = np.sort(
                        np.random.default_rng(seed + 2).choice(
                            num_queries, n_v, replace=False
                        )
                    )
                    exact = bool(
                        (host[vidx] == search_oracle(index, queries[vidx])).all()
                    )

                rec = {
                    "refsize": refsize,
                    "k": k,
                    "d": d,
                    "engine": engine,
                    "lut_m": lut_m,
                    "num_queries": num_queries,
                    "query_len": query_len,
                    "build_s": round(build_s, 2),
                    "seconds_per_pass": dt,
                    "reads_per_s": round(num_queries / dt),
                    "steps_per_s": round(num_queries * (query_len // k) / dt),
                    "bit_exact": exact,
                }
                records.append(rec)
                line = json.dumps(rec)
                print(line, flush=True)
                if fh:
                    fh.write(line + "\n")
                    fh.flush()
    if fh:
        fh.close()
    return records


if __name__ == "__main__":
    run_sweep()
