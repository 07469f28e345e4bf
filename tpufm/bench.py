"""Benchmark harness: the reference's TIME: protocol (mean of N timed
passes over a fixed read batch, common/searchQueries.c:78-118) plus a
structured JSON run record and a baseline comparison.

Baseline: BASELINE.md documents that the reference publishes no numbers, only
the protocol. When the reference CPU binaries are compilable on this host we
run fmIndexSearchCPU on the same workload and report vs_baseline as the
measured speedup; otherwise vs_baseline is null. The fraction of the
analytic HBM speed-of-light is reported under its own name, against the
device's published peak (HBM_PEAK_BYTES_PER_S), and is null on the CPU.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import numpy as np

#: gitignored scratch for reference-binary runs and cached genome indexes
CACHE_DIR = Path(__file__).resolve().parent.parent / ".benchcache"

#: published HBM peak bytes/s by jax device_kind. Source: NVIDIA H100
#: Tensor Core GPU data sheet, SXM part (80 GB HBM3 at 3.35 TB/s).
HBM_PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_peak_bytes_per_s(device) -> float | None:
    """The device's published HBM peak; None on the CPU, which has no
    device metric. An accelerator missing from the table is an error."""
    if device.platform == "cpu":
        return None
    try:
        return HBM_PEAK_BYTES_PER_S[device.device_kind]
    except KeyError:
        raise ValueError(
            f"no published HBM peak for device kind {device.device_kind!r}; "
            "add it to HBM_PEAK_BYTES_PER_S with its source"
        ) from None


def device_fields() -> dict:
    """The device every record names: platform, kind and count."""
    import jax

    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }


def measure_reference_cpu(
    codes, k, d, queries, workdir, threads: int = 1, index=None,
) -> float | None:
    """Seconds per pass of the reference fmIndexSearchCPU on this host (its
    own mean-of-5 TIME: protocol), or None when the toolchain is unavailable.

    threads > 1 runs the binary with that many OpenMP threads — the
    reference protocol's unit was a 24-core OpenMP node (BASELINE.md,
    scripts/sge_searchcpu_bases_likwid_MEM.sh:45 pins -C 0-23).

    index: when given, the .fmi the reference binary loads is written as
    tpufm's byte-exact tag-100 image of THAT index (formats.write_fmi)
    instead of running the reference builder — at genome scale the
    reference's own build costs tens of minutes (divsufsort + the serial
    LF walk, src/genFMindex.c:327-400) while the image write streams in
    seconds, and feeding the image doubles as a full-scale format-compat
    proof."""
    sys.path.insert(0, str(Path(__file__).parent.parent / "tests"))
    try:
        from refparity import build_reference_binaries, run
    except ImportError:
        return None
    bins = build_reference_binaries(k, d)
    if bins is None:
        return None

    from tpufm.io.fasta import write_reference
    from tpufm.io.genreads import write_reads_fasta
    from tpufm.utils.encoding import decode_bases

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    n = len(codes)
    ref_fa = workdir / "bench_ref.fa"
    fmi = workdir / f"bench_ref.fa.{n}.{d}fmi{k}steps.fmi"
    if not fmi.exists():
        if index is not None:
            from tpufm.index.formats import write_fmi

            write_fmi(fmi, index)
        else:
            write_reference(ref_fa, decode_bases(codes))
            run([bins["builder"], ref_fa, n], cwd=workdir)
    qry = workdir / "bench.qry"
    write_reads_fasta(qry, queries)
    out = run(
        [bins["search"], fmi, qry, queries.shape[1], queries.shape[0]],
        cwd=workdir,
        env={"OMP_NUM_THREADS": str(threads)},
    )
    for line in out.stdout.decode().splitlines():
        if line.startswith("TIME:"):
            return float(line.split()[-1])
    return None


def verify_full_cpu(index, queries, host_out) -> bool:
    """Bit-exactness of the FULL result batch against a CPU-backend twin
    engine (lut-free fused layout — the (L, R) output contract is layout-
    and LUT-independent). This is the reference's diffable .res contract
    (common/common.c:201-220) applied to every read instead of a sample;
    the independent (different-code-path) oracle still checks a sample."""
    import jax

    from tpufm.engine.xla import XLAEngine

    cpu = jax.local_devices(backend="cpu")[0]
    with jax.default_device(cpu):
        eng = XLAEngine(index, device=cpu, lut_m=0)
        out = eng.search(np.asarray(queries))
    return bool(np.array_equal(np.asarray(host_out), np.asarray(out)))


def gather_traffic_bytes(eng, num_queries: int, query_len: int) -> int | None:
    """Payload bytes a fused-layout engine gathers per pass: per round each
    interval end fetches one entry row, plus one 8 B LUT interval per read.
    Dividing by the measured pass time gives the achieved random-access HBM
    payload rate — the automated analog of the reference's likwid MEM
    region stamp (scripts/sge_searchcpu_bases_likwid_MEM.sh:45), computed
    from known per-round traffic instead of uncore PMCs."""
    if getattr(eng, "layout", None) != "fused" or getattr(eng, "tail_d", None):
        return None
    rounds = (query_len - eng.lut_m) // eng.config.k
    row_bytes = 4 * eng.tables["entries"].shape[1]
    per_read = rounds * 2 * row_bytes + (8 if eng.lut_m else 0)
    return num_queries * per_read


def _time_search(eng, queries, engine: str, iterations: int):
    """The reference TIME: protocol (mean of `iterations` passes), each
    pass ending in block_until_ready. Returns (seconds_per_pass, results
    as a host array). Chooses the device-resident waved path when the
    padded batch fits, matching the engine's production paths."""
    import jax
    import jax.numpy as jnp

    from tpufm.engine.xla import XLAEngine
    from tpufm.utils.timer import timed_device_passes

    num_queries, query_len = queries.shape
    if num_queries > XLAEngine.WAVE and engine == "xla":
        wave = XLAEngine.WAVE
        pad = -num_queries % wave
        qpad = (
            np.concatenate([queries, np.zeros((pad, query_len), np.uint8)])
            if pad
            else queries
        )
        if qpad.nbytes <= 2 << 30:
            qd = jax.device_put(jnp.asarray(qpad, jnp.uint8))
            jax.block_until_ready(eng.search_device_waved(qd))  # warm/compile
            t0 = time.perf_counter()
            for _ in range(iterations):
                out = jax.block_until_ready(eng.search_device_waved(qd))
            search_s = (time.perf_counter() - t0) / iterations
            return search_s, np.asarray(jax.device_get(out[:num_queries]))
        eng.search(queries[:wave])  # warm/compile
        t0 = time.perf_counter()
        for _ in range(iterations):
            res = eng.search(queries)
        return (time.perf_counter() - t0) / iterations, np.asarray(res)
    if num_queries > XLAEngine.WAVE:
        # Engines without a device-resident waved search stream host
        # waves — warm with that same batch so the timed passes never
        # recompile.
        eng.search(queries)  # warm/compile
        t0 = time.perf_counter()
        for _ in range(iterations):
            res = eng.search(queries)
        return (time.perf_counter() - t0) / iterations, np.asarray(res)
    qd = jax.device_put(jnp.asarray(queries, jnp.uint8))
    search_s, _ = timed_device_passes(
        lambda: eng.search_device(qd), iterations=iterations
    )
    out = eng.search_device(qd)
    if isinstance(out, tuple):  # paired layout returns (intervals, ok)
        out = out[0]
    return search_s, np.asarray(jax.device_get(out))


def _verify_and_measure(index, eng, queries, host_out, search_s, seed,
                        full_verify, k: int, query_len: int) -> dict:
    """The record fields every search benchmark shares: two-layer
    verification (oracle sample + full-batch CPU twin), rates, analytic
    SoL against the device's published HBM peak (null on the CPU), and
    achieved gather traffic. One implementation so the flagship and
    genome records cannot drift."""
    import jax

    from tpufm.engine.oracle import search_oracle

    num_queries = queries.shape[0]
    n_oracle = min(num_queries, 65536)
    vidx = np.sort(
        np.random.default_rng(seed + 2).choice(num_queries, n_oracle,
                                               replace=False)
    )
    exact_oracle = bool(
        (host_out[vidx] == search_oracle(index, queries[vidx])).all()
    )
    if full_verify is None:
        full_verify = os.environ.get("TPUFM_BENCH_FULL_VERIFY", "1") != "0"
    exact_full = (
        verify_full_cpu(index, queries, host_out) if full_verify else None
    )
    rounds = query_len // k
    steps_s = num_queries * rounds / search_s
    hbm_bw = hbm_peak_bytes_per_s(jax.devices()[0])
    bytes_per_step = 2 * (4 + 4 * index.config.bitmap_words)
    sol_steps_s = hbm_bw / bytes_per_step if hbm_bw else None
    traffic = gather_traffic_bytes(eng, num_queries, query_len)
    return {
        "steps_per_s": steps_s,
        "fields": {
            "reads_per_s": round(num_queries / search_s),
            "seconds_per_pass": search_s,
            "speed_of_light_steps_per_s": (
                round(sol_steps_s) if sol_steps_s else None
            ),
            "fraction_of_sol": (
                round(steps_s / sol_steps_s, 4) if sol_steps_s else None
            ),
            "achieved_hbm_gbps": (
                round(traffic / search_s / 1e9, 2)
                if traffic and hbm_bw else None
            ),
            "gathered_bytes_per_pass": traffic,
            "bit_exact_vs_oracle": exact_oracle and exact_full is not False,
            "bit_exact_vs_oracle_sample": exact_oracle,
            "bit_exact_vs_cpu_engine_full": exact_full,
            "verified_reads": num_queries if full_verify else n_oracle,
            "verified_reads_oracle": n_oracle,
        },
    }


def run_bench(
    refsize: int = 10_000_000,
    k: int = 2,
    d: int = 64,
    num_queries: int = 131072,
    query_len: int = 120,
    iterations: int = 5,
    seed: int = 0,
    engine: str = "xla",
    lut_m: int = 0,
    pad_words: int | None = None,
    compare_reference: bool = True,
    full_verify: bool | None = None,
) -> dict:
    from tpufm.config import IndexConfig
    from tpufm.engine.xla import XLAEngine
    from tpufm.engine.oracle import search_oracle
    from tpufm.index.builder import build_index
    from tpufm.index.layouts import make_alt_counters
    from tpufm.io.genreads import generate_reads

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=refsize, dtype=np.uint8)

    t0 = time.perf_counter()
    index = build_index(codes, IndexConfig(k=k, d=d))
    build_s = time.perf_counter() - t0

    queries = generate_reads(codes, query_len, num_queries, seed=seed + 1)

    if engine == "xla-ac":
        eng = XLAEngine(make_alt_counters(index))
    elif engine == "xla-paired":
        eng = XLAEngine(index, layout="paired", lut_m=lut_m or 12)
    elif engine == "xla-split":
        eng = XLAEngine(index, layout="split", lut_m=lut_m)
    elif engine == "xla":
        eng = XLAEngine(index, lut_m=lut_m, pad_words=pad_words)
    else:
        raise ValueError(f"unknown engine {engine!r}")

    search_s, host_out = _time_search(eng, queries, engine, iterations)

    repair_fraction = None
    if engine == "xla-paired":
        # The timed value is the paired hot path; verification goes through
        # engine.search so wide-interval repair lanes are bit-exact too.
        host_out = eng.search(queries)
        repair_fraction = eng.last_repair_fraction

    # Correctness, two layers: (1) the independent NumPy oracle on a uniform
    # random sample, (2) the FULL batch against a CPU-backend twin engine —
    # every read of the record is verified (verified_reads == num_queries).
    vm = _verify_and_measure(index, eng, queries, host_out, search_s, seed,
                             full_verify, k, query_len)
    steps_s = vm["steps_per_s"]

    # Honest baseline framing: the reference protocol's unit was a 24-core
    # OpenMP node (likwid -C 0-23). We measure single-core always; when this
    # host has >1 cores we ALSO measure the all-core OpenMP run, and the
    # headline vs_baseline uses the strongest reference number available.
    ref_s = ref_node_s = None
    n_cores = os.cpu_count() or 1
    if compare_reference:
        # seed-scoped: the cached reference .fmi must match THESE codes
        refdir = CACHE_DIR / "refrun" / f"s{seed}"
        ref_s = measure_reference_cpu(codes, k, d, queries, refdir, threads=1)
        if ref_s and n_cores > 1:
            ref_node_s = measure_reference_cpu(
                codes, k, d, queries, refdir, threads=n_cores
            )

    strongest_ref = ref_node_s or ref_s
    vs_baseline = (strongest_ref / search_s) if strongest_ref else None

    detail = {
        **device_fields(),
        "reference_cpu_seconds_per_pass": ref_s,
        "reference_cpu_seconds_per_pass_node": ref_node_s,
        "reference_cpu_cores": 1 if ref_s else None,
        "reference_cpu_cores_node": n_cores if ref_node_s else None,
        "reference_protocol_node": "24-core OpenMP node (likwid -C 0-23)",
        "vs_baseline_single_core": (
            round(ref_s / search_s, 4) if ref_s else None
        ),
        "vs_baseline_node": (
            round(ref_node_s / search_s, 4) if ref_node_s else None
        ),
        "node_equivalent_caveat": (
            f"vs_baseline compares one device against the reference on "
            f"{n_cores} core(s) of THIS host; the reference protocol's "
            "own unit was a 24-core OpenMP node — scale the single-core "
            "number accordingly (BASELINE.md 'Baseline framing')"
        ),
        "build_seconds": round(build_s, 1),
        "repair_fraction": repair_fraction,
        "iterations": iterations,
    }
    detail.update(vm["fields"])
    return {
        "metric": f"k-step backward-search steps/s/chip (k={k}, d={d}, "
        f"{num_queries} reads x {query_len} bp, engine={engine})",
        "value": round(steps_s),
        "unit": "steps/s",
        "vs_baseline": round(vs_baseline, 4) if vs_baseline else None,
        "detail": detail,
    }


def run_bench_genome(
    refsize: int = 250_000_000,
    k: int | None = None,
    d: int | None = None,
    num_queries: int = 1 << 20,
    query_len: int = 120,
    iterations: int = 5,
    seed: int = 0,
    lut_m: int | None = None,
    compare_reference: bool = True,
    full_verify: bool | None = None,
    cache_dir=None,
) -> dict:
    """Genome-scale record — the regime the reference protocol actually
    swept (scripts/slurm_genindexes.sh:42 builds 0.75-3 Gbase references;
    sge_searchcpu_bases.sh:28 searches them).

    The flagship 10 Mbase table fits in cache; this one measures a REAL
    >=250 Mbase index whose entries gather from HBM, with the reference
    fmIndexSearchCPU compared at the SAME size — fed tpufm's byte-exact
    tag-100 image of this very index, which is simultaneously a
    full-scale on-disk-format compat proof.

    The built index and its .fmi image cache under CACHE_DIR/genome so
    repeat runs skip the build; the cache is validated by (refsize, k, d,
    seed) in the filename and the engine's LUT fingerprint."""
    import jax

    from tpufm.config import IndexConfig, device_bytes_limit, recommend_config
    from tpufm.engine.xla import XLAEngine
    from tpufm.index.store import load_store, save_store
    from tpufm.io.genreads import generate_reads

    rec = recommend_config(
        refsize, query_len=query_len, bytes_limit=device_bytes_limit()
    )
    k = rec["k"] if k is None else k  # rec's k always divides query_len
    d = d or rec["d"]
    lut_m = rec["lut_m"] if lut_m is None else lut_m
    cache = Path(cache_dir or CACHE_DIR / "genome")
    cache.mkdir(parents=True, exist_ok=True)

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=refsize, dtype=np.uint8)

    store = cache / f"idx_{refsize}_k{k}_d{d}_s{seed}.tpufm"
    cached = store.exists()
    t0 = time.perf_counter()
    if cached:
        index = load_store(store)
        build_s = 0.0
    else:
        from tpufm.index.sa_device import device_build_fits

        if jax.default_backend() != "cpu" and device_build_fits(refsize):
            # device build, bit-identical to the host builder
            from tpufm.index.builder_device import build_index_device

            index = build_index_device(codes, IndexConfig(k=k, d=d))
        else:
            from tpufm.index.builder import build_index

            index = build_index(codes, IndexConfig(k=k, d=d))
        build_s = time.perf_counter() - t0
        save_store(store, index)

    queries = generate_reads(codes, query_len, num_queries, seed=seed + 1)
    eng = XLAEngine(
        index, lut_m=lut_m,
        lut_cache=str(cache / f"lut_{refsize}_k{k}_d{d}_s{seed}_m{lut_m}"),
    )
    search_s, host_out = _time_search(eng, queries, "xla", iterations)

    vm = _verify_and_measure(index, eng, queries, host_out, search_s, seed,
                             full_verify, k, query_len)
    steps_s = vm["steps_per_s"]

    ref_s = None
    if compare_reference:
        # seed-scoped: the cached .fmi image must match THESE codes
        refdir = cache / f"refrun_s{seed}"
        ref_s = measure_reference_cpu(
            codes, k, d, queries, refdir, threads=1, index=index
        )

    vs_baseline = (ref_s / search_s) if ref_s else None
    detail = {
        **device_fields(),
        "refsize": refsize,
        "d": d,
        "lut_m": lut_m,
        "reference_cpu_seconds_per_pass": ref_s,
        "reference_cpu_cores": 1 if ref_s else None,
        "vs_baseline_single_core": (
            round(ref_s / search_s, 4) if ref_s else None
        ),
        "reference_fed_tpufm_fmi_image": bool(ref_s),
        "build_seconds": round(build_s, 1),
        "index_cached": cached,
        "iterations": iterations,
    }
    detail.update(vm["fields"])
    return {
        "metric": f"genome-scale backward-search steps/s/chip (k={k}, d={d}, "
        f"{num_queries} reads x {query_len} bp, {refsize} bases)",
        "value": round(steps_s),
        "unit": "steps/s",
        "vs_baseline": round(vs_baseline, 4) if vs_baseline else None,
        "detail": detail,
    }


def run_bench_sharded(
    refsize: int = 10_000_000,
    k: int = 3,
    d: int = 128,
    num_queries: int = 524288,
    query_len: int = 120,
    iterations: int = 5,
    seed: int = 0,
    lut_m: int = 0,
    routing: str = "allgather",
    n_devices: int | None = None,
) -> dict:
    """Sharded-index (entry table sharded over the mesh) scaling benchmark.

    Weak-scaling protocol mirrors run_bench_multichip: the per-chip read
    shard is timed on a 1-device mesh (where every routing degenerates to
    local answering), and vs_baseline is reads_s(N) / (N * reads_s(1)).
    For routing='a2a' the record also reports the fraction of LF rounds
    that hit the overflow fallback."""
    import jax

    from tpufm.config import IndexConfig
    from tpufm.engine.oracle import search_oracle
    from tpufm.index.builder import build_index
    from tpufm.io.genreads import generate_reads
    from tpufm.parallel import make_mesh, ShardedIndexEngine
    from tpufm.utils.timer import timed_device_passes

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=refsize, dtype=np.uint8)
    index = build_index(codes, IndexConfig(k=k, d=d))
    mesh = make_mesh(n_devices)
    n_dev = mesh.devices.size
    num_queries -= num_queries % n_dev
    queries = generate_reads(codes, query_len, num_queries, seed=seed + 1)

    def timed_run(m, q):
        eng = ShardedIndexEngine(index, m, routing=routing, lut_m=lut_m)
        qd = eng.place_queries(q)
        dt, _ = timed_device_passes(
            lambda: eng.search_device(qd), iterations=iterations
        )
        return dt, eng, qd

    one_s, _, _ = timed_run(make_mesh(1), queries[: num_queries // n_dev])
    one_chip_reads_s = (num_queries // n_dev) / one_s

    search_s, eng, qd = timed_run(mesh, queries)
    out_h, ov_h = eng.search_device(qd)
    out = np.asarray(jax.device_get(out_h))
    ov = np.asarray(jax.device_get(ov_h))
    n_verify = min(num_queries, 65536)
    vidx = np.sort(
        np.random.default_rng(seed + 2).choice(num_queries, n_verify, replace=False)
    )
    exact = bool((out[vidx] == search_oracle(index, queries[vidx])).all())

    reads_s = num_queries / search_s
    efficiency = reads_s / (n_dev * one_chip_reads_s)
    return {
        "metric": f"sharded-index ({routing}) scaling efficiency over {n_dev} "
        f"device(s) (k={k}, d={d}, lut_m={lut_m}, {num_queries} reads x "
        f"{query_len} bp)",
        "value": round(reads_s),
        "unit": "reads/s",
        "vs_baseline": round(efficiency, 4),
        "detail": {
            "devices": n_dev,
            "routing": routing,
            "scaling_efficiency": round(efficiency, 4),
            "reads_per_s_one_chip": round(one_chip_reads_s),
            "reads_per_s_per_chip": round(reads_s / n_dev),
            "seconds_per_pass": search_s,
            "overflow_round_fraction": round(float(ov.mean()), 4),
            "bit_exact_vs_oracle": exact,
            "verified_reads": n_verify,
        },
    }


def run_bench_locate(
    refsize: int = 10_000_000,
    d: int = 128,
    sample_rate: int = 32,
    num_rows: int = 2 << 20,
    iterations: int = 5,
    seed: int = 0,
    n_devices: int | None = None,
) -> dict:
    """positions/s record for the sampled-SA locate walk. With n_devices
    (or >1 local devices) uses DataParallelLocate and reports weak-scaling
    efficiency as vs_baseline (1.0 on a single device)."""
    import jax

    from tpufm.index.locate import build_locate, locate_oracle
    from tpufm.parallel import make_mesh, DataParallelLocate
    from tpufm.utils.timer import timed_device_passes

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=refsize, dtype=np.uint8)
    t0 = time.perf_counter()
    loc = build_locate(codes, sample_rate=sample_rate, d=d)
    build_s = time.perf_counter() - t0

    mesh = make_mesh(n_devices)
    n_dev = mesh.devices.size
    num_rows -= num_rows % n_dev
    rows = rng.integers(0, refsize + 1, size=num_rows, dtype=np.uint32)

    def timed_run(m, r):
        eng = DataParallelLocate(loc, m)
        rd = eng.place_rows(r)
        dt, _ = timed_device_passes(
            lambda: eng.locate_device(rd), iterations=iterations
        )
        return dt, eng, rd

    one_s, _, _ = timed_run(make_mesh(1), rows[: num_rows // n_dev])
    one_chip_pos_s = (num_rows // n_dev) / one_s

    loc_s, eng, rd = timed_run(mesh, rows)
    out = np.asarray(jax.device_get(eng.locate_device(rd)))
    n_verify = min(num_rows, 65536)
    vidx = np.sort(
        np.random.default_rng(seed + 2).choice(num_rows, n_verify, replace=False)
    )
    exact = bool((out[vidx] == locate_oracle(loc, rows[vidx])).all())

    pos_s = num_rows / loc_s
    efficiency = pos_s / (n_dev * one_chip_pos_s)
    return {
        "metric": f"sampled-SA locate positions/s over {n_dev} device(s) "
        f"(d={d}, s={sample_rate}, {num_rows} rows, {refsize} bases)",
        "value": round(pos_s),
        "unit": "positions/s",
        "vs_baseline": round(efficiency, 4),
        "detail": {
            "devices": n_dev,
            "scaling_efficiency": round(efficiency, 4),
            "positions_per_s_one_chip": round(one_chip_pos_s),
            "positions_per_s_per_chip": round(pos_s / n_dev),
            "seconds_per_pass": loc_s,
            "build_seconds": round(build_s, 1),
            "bit_exact_vs_oracle": exact,
            "verified_rows": n_verify,
        },
    }


def run_bench_search_locate(
    refsize: int = 10_000_000,
    k: int = 3,
    d: int = 128,
    sample_rate: int = 32,
    num_queries: int = 1 << 20,
    query_len: int = 120,
    iterations: int = 5,
    seed: int = 0,
    lut_m: int = 0,
    max_hits: int = 4,
) -> dict:
    """Fused one-pass search+locate record (SearchLocateEngine): reads in,
    text positions out, one device program. Verified on a uniform read
    sample against the HOST oracles (search_oracle + locate_hits)."""

    from tpufm.config import IndexConfig
    from tpufm.engine.oracle import search_oracle
    from tpufm.engine.xla import SearchLocateEngine
    from tpufm.index.builder import build_index
    from tpufm.index.locate import build_locate, locate_hits
    from tpufm.index.suffix_array import suffix_array
    from tpufm.io.genreads import generate_reads

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=refsize, dtype=np.uint8)
    t0 = time.perf_counter()
    sa = suffix_array(codes)
    index = build_index(codes, IndexConfig(k=k, d=d), sa=sa)
    loc = build_locate(codes, sample_rate=sample_rate, d=d, sa=sa)
    build_s = time.perf_counter() - t0
    queries = generate_reads(codes, query_len, num_queries, seed=seed + 1)

    eng = SearchLocateEngine(index, loc, max_hits=max_hits, lut_m=lut_m)
    eng.search_locate(queries)  # warm / compile
    times = []
    for _ in range(iterations):
        t0 = time.perf_counter()
        iv, pos = eng.search_locate(queries)  # host fetch = true barrier
        times.append(time.perf_counter() - t0)
    mean_s = sum(times) / len(times)

    n_verify = min(num_queries, 8192)
    vidx = np.sort(
        np.random.default_rng(seed + 2).choice(
            num_queries, n_verify, replace=False
        )
    )
    iv_o = np.asarray(search_oracle(index, queries[vidx]))
    pos_o = locate_hits(loc, iv_o, max_hits=max_hits)
    exact = bool((iv[vidx] == iv_o).all() and (pos[vidx] == pos_o).all())

    reads_s = num_queries / mean_s
    return {
        "metric": f"fused search+locate reads/s (k={k}, d={d}, "
        f"s={sample_rate}, max_hits={max_hits}, lut={lut_m}, "
        f"{num_queries} x {query_len} bp, {refsize} bases)",
        "value": round(reads_s),
        "unit": "reads/s",
        "vs_baseline": None,
        "detail": {
            "reads_per_s": round(reads_s),
            "positions_per_s": round(reads_s * max_hits),
            "seconds_per_pass": mean_s,
            "build_seconds": round(build_s, 1),
            "bit_exact_vs_oracle": exact,
            "verified_reads": n_verify,
            "max_hits": max_hits,
        },
    }


def run_bench_mismatch(
    refsize: int = 10_000_000,
    k: int = 3,
    d: int = 128,
    num_queries: int = 1 << 16,
    query_len: int = 120,
    iterations: int = 3,
    seed: int = 0,
    lut_m: int = 0,
    error_rate: float = 1.0,
) -> dict:
    """Hamming<=1 counting record (XLAEngine.count(mismatches=1)): each read
    fans out to 3L+1 on-device variants, so the interesting rates are both
    reads/s and effective variant-lanes/s (comparable to the exact-search
    reads/s). error_rate: fraction of sampled reads given ONE planted
    substitution — these reads' exact search misses, the mismatch count
    must recover them (asserted on the verification sample vs a naive
    sliding-window Hamming scan)."""

    from tpufm.config import IndexConfig
    from tpufm.engine.xla import XLAEngine
    from tpufm.index.builder import build_index
    from tpufm.io.genreads import generate_reads

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=refsize, dtype=np.uint8)
    t0 = time.perf_counter()
    index = build_index(codes, IndexConfig(k=k, d=d))
    build_s = time.perf_counter() - t0
    queries = np.asarray(
        generate_reads(codes, query_len, num_queries, seed=seed + 1)
    )
    n_err = int(num_queries * error_rate)
    if n_err:
        pos = rng.integers(0, query_len, size=n_err)
        off = rng.integers(1, 4, size=n_err).astype(np.uint8)
        rows = np.arange(n_err)
        queries[rows, pos] = (queries[rows, pos] + off) & 3

    eng = XLAEngine(index, lut_m=lut_m)
    cnt = eng.count(queries, mismatches=1)  # warm / compile
    times = []
    for _ in range(iterations):
        t0 = time.perf_counter()
        cnt = eng.count(queries, mismatches=1)
        times.append(time.perf_counter() - t0)
    mean_s = sum(times) / len(times)

    n_verify = min(num_queries, 512)  # naive scan is O(n * L) per read
    vidx = np.sort(
        np.random.default_rng(seed + 2).choice(
            num_queries, n_verify, replace=False
        )
    )
    wins = np.lib.stride_tricks.sliding_window_view(codes, query_len)
    want = np.array(
        [((wins != q[None]).sum(1) <= 1).sum() for q in queries[vidx]],
        dtype=np.uint32,
    )
    exact = bool((cnt[vidx] == want).all())

    reads_s = num_queries / mean_s
    fan = 3 * query_len + 1
    return {
        "metric": f"Hamming<=1 count reads/s (k={k}, d={d}, lut={lut_m}, "
        f"{num_queries} x {query_len} bp, {refsize} bases, "
        f"{fan} variants/read)",
        "value": round(reads_s),
        "unit": "reads/s",
        "vs_baseline": None,  # the reference has no approximate matching
        "detail": {
            "reads_per_s": round(reads_s),
            "variant_lanes_per_s": round(reads_s * fan),
            "seconds_per_pass": mean_s,
            "build_seconds": round(build_s, 1),
            "bit_exact_vs_naive": exact,
            "verified_reads": n_verify,
            "planted_error_reads": n_err,
            "recovered": int((cnt > 0).sum()),
        },
    }


def run_bench_seed(
    refsize: int = 10_000_000,
    k: int = 3,
    d: int = 128,
    sample_rate: int = 32,
    num_queries: int = 1 << 16,
    query_len: int = 120,
    iterations: int = 3,
    seed: int = 0,
    lut_m: int = 0,
    mismatches: int = 2,
    seed_hits: int = 32,
    max_hits: int = 4,
    error_rate: float = 1.0,
) -> dict:
    """Pigeonhole seed-and-extend record (SeedExtendEngine.locate_approx):
    positions of every occurrence within Hamming distance m >= 2, one jit
    per wave. error_rate: fraction of sampled reads given exactly m planted
    substitutions — exact search misses all of them, the seed pass must
    recover them. Verification: a uniform sample's counts + positions vs a
    naive sliding-window Hamming scan (overflow-flagged reads excluded from
    the exactness claim — their lists are lower bounds by contract)."""

    from tpufm.config import IndexConfig
    from tpufm.engine.seed import SeedExtendEngine
    from tpufm.index.builder import build_index
    from tpufm.index.locate import build_locate
    from tpufm.index.suffix_array import suffix_array
    from tpufm.io.genreads import generate_reads

    m = mismatches
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=refsize, dtype=np.uint8)
    t0 = time.perf_counter()
    sa = suffix_array(codes)
    index = build_index(codes, IndexConfig(k=k, d=d), sa=sa)
    loc = build_locate(codes, sample_rate=sample_rate, d=d, sa=sa)
    build_s = time.perf_counter() - t0
    queries = np.asarray(
        generate_reads(codes, query_len, num_queries, seed=seed + 1)
    )
    n_err = int(num_queries * error_rate)
    if n_err:
        # exactly m substitutions per read: positions drawn WITHOUT
        # replacement per read (independent draws could collide or revert)
        pos = np.argsort(rng.random((n_err, query_len)), axis=1)[:, :m]
        off = rng.integers(1, 4, size=(n_err, m)).astype(np.uint8)
        rows = np.arange(n_err)[:, None]
        queries[rows, pos] = (queries[rows, pos] + off) & 3

    eng = SeedExtendEngine(
        index, loc, codes, mismatches=m, seed_hits=seed_hits,
        max_hits=max_hits, lut_m=lut_m,
    )
    out = eng.locate_approx(queries)  # warm / compile
    times = []
    for _ in range(iterations):
        t0 = time.perf_counter()
        out = eng.locate_approx(queries)
        times.append(time.perf_counter() - t0)
    mean_s = sum(times) / len(times)
    positions, counts, overflow = out

    n_verify = min(num_queries, 256)  # naive scan is O(n * L) per read
    vidx = np.sort(
        np.random.default_rng(seed + 2).choice(
            num_queries, n_verify, replace=False
        )
    )
    wins = np.lib.stride_tricks.sliding_window_view(codes, query_len)
    exact = True
    for i in vidx:
        dist = (wins != queries[i][None]).sum(axis=1)
        want = np.flatnonzero(dist <= m).astype(np.uint32)
        got = positions[i][positions[i] != 0xFFFFFFFF]
        if overflow[i]:
            # lower-bound contract: every reported position must be real
            exact &= bool(np.isin(got, want).all())
        else:
            exact &= int(counts[i]) == want.size
            exact &= bool((got == want[: got.size]).all())

    reads_s = num_queries / mean_s
    return {
        "metric": f"seed-extend locate reads/s (m={m}, k={k}, d={d}, "
        f"lut={lut_m}, s={sample_rate}, seed_hits={seed_hits}, "
        f"{num_queries} x {query_len} bp, {refsize} bases)",
        "value": round(reads_s),
        "unit": "reads/s",
        "vs_baseline": None,  # the reference has no approximate matching
        "detail": {
            "reads_per_s": round(reads_s),
            "seed_lanes_per_s": round(reads_s * (m + 1)),
            "seconds_per_pass": mean_s,
            "build_seconds": round(build_s, 1),
            "bit_exact_vs_naive": exact,
            "verified_reads": n_verify,
            "planted_error_reads": n_err,
            "overflow_reads": int(overflow.sum()),
            "recovered": int((counts > 0).sum()),
        },
    }


def run_bench_edit(
    refsize: int = 10_000_000,
    k: int = 3,
    d: int = 128,
    sample_rate: int = 32,
    num_queries: int = 1 << 14,
    query_len: int = 120,
    iterations: int = 3,
    seed: int = 0,
    lut_m: int = 0,
    edits: int = 2,
    seed_hits: int = 32,
    max_hits: int = 4,
) -> dict:
    """Indel-aware alignment record (EditExtendEngine.locate_edits):
    distinct alignment start sites within edit distance E, Myers-verified.
    Every read carries E planted mixed edits (substitution/insert/delete) —
    exact search AND the Hamming path miss the indel-mutated ones; this
    pass must recover each origin's site. Verification: a uniform sample's
    sites vs the reversed semi-global DP oracle (soundness: every reported
    site <= E; sensitivity: a site within 2E of the origin — the verifier
    reports the LEFTMOST minimal start of each +-E candidate window, which
    can sit up to 2E from the planted origin when an equivalent-cost
    alignment starts earlier)."""

    from tpufm.config import IndexConfig
    from tpufm.engine.edit import EditExtendEngine, edit_extend_oracle
    from tpufm.index.builder import build_index
    from tpufm.index.locate import build_locate
    from tpufm.index.suffix_array import suffix_array

    E = edits
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=refsize, dtype=np.uint8)
    t0 = time.perf_counter()
    sa = suffix_array(codes)
    index = build_index(codes, IndexConfig(k=k, d=d), sa=sa)
    loc = build_locate(codes, sample_rate=sample_rate, d=d, sa=sa)
    build_s = time.perf_counter() - t0

    L = query_len
    origins = rng.integers(0, refsize - L - E, size=num_queries)
    reads = np.empty((num_queries, L), np.uint8)
    for i, s0 in enumerate(origins):
        w = list(codes[s0 : s0 + L + E])
        for _ in range(E):
            op = rng.integers(0, 3)
            p = int(rng.integers(0, len(w) - 1))
            if op == 0:
                w[p] = (w[p] + int(rng.integers(1, 4))) & 3
            elif op == 1:
                del w[p]
            else:
                w.insert(p, int(rng.integers(0, 4)))
        reads[i] = w[:L]

    eng = EditExtendEngine(
        index, loc, codes, edits=E, seed_hits=seed_hits,
        max_hits=max_hits, lut_m=lut_m,
    )
    out = eng.locate_edits(reads)  # warm / compile
    times = []
    for _ in range(iterations):
        t0 = time.perf_counter()
        out = eng.locate_edits(reads)
        times.append(time.perf_counter() - t0)
    mean_s = sum(times) / len(times)
    positions, counts, overflow = out

    n_verify = min(num_queries, 128)  # DP oracle is O(n * L) per read
    vidx = np.sort(
        np.random.default_rng(seed + 2).choice(
            num_queries, n_verify, replace=False
        )
    )
    want = edit_extend_oracle(codes, reads[vidx], E)
    sound = sensitive = True
    for row, (i, q) in enumerate(zip(vidx, reads[vidx])):
        got = positions[i][positions[i] != 0xFFFFFFFF].astype(np.int64)
        for s in got:
            sound &= bool(want[row, s] <= E)
        if not overflow[i]:
            sensitive &= got.size > 0 and int(
                np.abs(got - origins[i]).min()
            ) <= 2 * E

    reads_s = num_queries / mean_s
    return {
        "metric": f"edit-distance locate reads/s (E={E}, k={k}, d={d}, "
        f"lut={lut_m}, s={sample_rate}, seed_hits={seed_hits}, "
        f"{num_queries} x {query_len} bp, {refsize} bases)",
        "value": round(reads_s),
        "unit": "reads/s",
        "vs_baseline": None,  # the reference has no approximate matching
        "detail": {
            "reads_per_s": round(reads_s),
            "myers_lanes_per_s": round(reads_s * (E + 1) * seed_hits),
            "seconds_per_pass": mean_s,
            "build_seconds": round(build_s, 1),
            "sound_vs_dp_oracle": sound,
            "origin_recovered_sample": sensitive,
            "verified_reads": n_verify,
            "overflow_reads": int(overflow.sum()),
            "recovered": int((counts > 0).sum()),
        },
    }


def run_bench_paired(
    refsize: int = 10_000_000,
    k: int = 3,
    d: int = 128,
    sample_rate: int = 32,
    num_pairs: int = 1 << 17,
    query_len: int = 120,
    insert_min: int = 250,
    insert_max: int = 450,
    iterations: int = 3,
    seed: int = 0,
    lut_m: int = 0,
    max_hits: int = 4,
    max_pairs: int = 4,
) -> dict:
    """Paired-end FR placement record (PairedEndEngine.pair): generated
    pairs with known truth (generate_read_pairs) timed through the
    4B-read fused batch + on-device insert join. Verified: every truth
    (left, right, strand) triple recovered, and a uniform sample checked
    against the exhaustive cross-join oracle."""

    from tpufm.config import IndexConfig
    from tpufm.engine.paired import PairedEndEngine, pair_oracle
    from tpufm.index.builder import build_index
    from tpufm.index.locate import build_locate
    from tpufm.index.suffix_array import suffix_array
    from tpufm.io.genreads import generate_read_pairs

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=refsize, dtype=np.uint8)
    t0 = time.perf_counter()
    sa = suffix_array(codes)
    index = build_index(codes, IndexConfig(k=k, d=d), sa=sa)
    loc = build_locate(codes, sample_rate=sample_rate, d=d, sa=sa)
    build_s = time.perf_counter() - t0

    r1, r2, (ls, rs, minus) = generate_read_pairs(
        codes, query_len, num_pairs, insert_min, insert_max,
        seed=seed + 1, return_truth=True,
    )
    eng = PairedEndEngine(
        index, loc, insert_min, insert_max, max_hits=max_hits,
        max_pairs=max_pairs, lut_m=lut_m,
    )
    out = eng.pair(r1, r2)  # warm / compile
    times = []
    for _ in range(iterations):
        t0 = time.perf_counter()
        out = eng.pair(r1, r2)
        times.append(time.perf_counter() - t0)
    mean_s = sum(times) / len(times)
    pairs, strand, counts, overflow = out

    truth_found = 0
    for i in range(num_pairs):
        sym = 1 if minus[i] else 0
        truth_found += any(
            pairs[i, j, 0] == ls[i] and pairs[i, j, 1] == rs[i]
            and strand[i, j] == sym
            for j in range(max_pairs)
        )
    n_verify = min(num_pairs, 64)  # oracle scans the text per mate
    vidx = np.sort(
        np.random.default_rng(seed + 2).choice(num_pairs, n_verify, replace=False)
    )
    want = pair_oracle(codes, r1[vidx], r2[vidx], insert_min, insert_max)
    exact = True
    for row, i in enumerate(vidx):
        got = {
            (int(pairs[i, j, 0]), int(pairs[i, j, 1]), int(strand[i, j]))
            for j in range(max_pairs)
            if pairs[i, j, 0] != 0xFFFFFFFF
        }
        if overflow[i]:
            # lower-bound contract: every reported pair must be real
            exact &= got <= set(want[row])
        else:
            exact &= int(counts[i]) == len(want[row])
            if counts[i] <= max_pairs:
                exact &= got == set(want[row])

    pairs_s = num_pairs / mean_s
    return {
        "metric": f"paired-end placement pairs/s (k={k}, d={d}, "
        f"lut={lut_m}, insert [{insert_min}, {insert_max}], "
        f"{num_pairs} x 2 x {query_len} bp, {refsize} bases)",
        "value": round(pairs_s),
        "unit": "pairs/s",
        "vs_baseline": None,  # the reference has neither locate nor pairing
        "detail": {
            "pairs_per_s": round(pairs_s),
            "mate_reads_per_s": round(pairs_s * 2),
            "strand_lanes_per_s": round(pairs_s * 4),  # engine batch lanes
            "seconds_per_pass": mean_s,
            "build_seconds": round(build_s, 1),
            "truth_pairs_recovered": truth_found,
            "bit_exact_vs_oracle": exact,
            "verified_pairs": n_verify,
            "properly_paired": int((counts > 0).sum()),
            "overflow_pairs": int(overflow.sum()),
        },
    }


def run_bench_multichip(
    refsize: int = 10_000_000,
    k: int = 3,
    d: int = 128,
    num_queries: int = 524288,
    query_len: int = 120,
    iterations: int = 5,
    seed: int = 0,
    lut_m: int = 0,
    n_devices: int | None = None,
) -> dict:
    """Data-parallel scaling benchmark: index replicated per chip, batch
    sharded over the mesh (BASELINE.md scaling target: >=80% reads/s
    efficiency from 1 to N hosts).

    Weak-scaling protocol: the same per-chip read shard (num_queries /
    n_devices) is first timed on a 1-device mesh; vs_baseline is the scaling
    efficiency fraction reads_s(N) / (N * reads_s(1)) — 1.0 = perfect."""
    import jax

    from tpufm.config import IndexConfig
    from tpufm.engine.oracle import search_oracle
    from tpufm.index.builder import build_index
    from tpufm.io.genreads import generate_reads
    from tpufm.parallel import make_mesh, DataParallelEngine
    from tpufm.utils.timer import timed_device_passes

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=refsize, dtype=np.uint8)
    index = build_index(codes, IndexConfig(k=k, d=d))
    mesh = make_mesh(n_devices)
    n_dev = mesh.devices.size
    num_queries -= num_queries % n_dev
    queries = generate_reads(codes, query_len, num_queries, seed=seed + 1)

    def timed_run(m, q):
        eng = DataParallelEngine(index, m, lut_m=lut_m)
        qd = eng.shard_queries(q)
        dt, _ = timed_device_passes(
            lambda: eng.search_device(qd), iterations=iterations
        )
        return dt, eng, qd

    # Denominator: the per-chip shard on a 1-device mesh (weak scaling).
    one_s, _, _ = timed_run(make_mesh(1), queries[: num_queries // n_dev])
    one_chip_reads_s = (num_queries // n_dev) / one_s

    search_s, eng, qd = timed_run(mesh, queries)
    out = np.asarray(jax.device_get(eng.search_device(qd)))
    n_verify = min(num_queries, 65536)
    vidx = np.sort(
        np.random.default_rng(seed + 2).choice(num_queries, n_verify, replace=False)
    )
    exact = bool((out[vidx] == search_oracle(index, queries[vidx])).all())

    reads_s = num_queries / search_s
    efficiency = reads_s / (n_dev * one_chip_reads_s)
    return {
        "metric": f"data-parallel scaling efficiency over {n_dev} device(s) "
        f"(k={k}, d={d}, lut_m={lut_m}, {num_queries} reads x {query_len} bp)",
        "value": round(reads_s),
        "unit": "reads/s",
        "vs_baseline": round(efficiency, 4),
        "detail": {
            "devices": n_dev,
            "scaling_efficiency": round(efficiency, 4),
            "reads_per_s_one_chip": round(one_chip_reads_s),
            "reads_per_s_per_chip": round(reads_s / n_dev),
            "seconds_per_pass": search_s,
            "bit_exact_vs_oracle": exact,
            "verified_reads": n_verify,
        },
    }
